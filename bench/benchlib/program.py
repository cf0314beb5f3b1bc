"""The system under test, built from a configuration file: the port's
config, its serving-format weights and its ``Server``.

The float weights come from :mod:`reference.weights` (the run's seed, one
group at a time on the device); each quantizable leaf goes through the
port's public quantizer (``core.quantizer.quantize_leaf``) at the
configuration's width as soon as its group is drawn, so the card holds the
codes plus one group's floats at most.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference import weights

from . import traffic

# the port's prompt bucket: a prefill's rows round up to a multiple of it
BUCKET = 16
# fields of the port's config that must equal the file's ``model`` block
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
          "d_ff", "vocab_size", "act", "norm_eps", "rope_theta")


def port_config(conf: Dict):
    """The port's ``ModelConfig``: its preset with the file's overrides and
    the served PSI width; refused unless its widths are the file's."""
    from repro_torch.configs import get_config
    run = conf["run"]
    cfg = get_config(run["preset"], **run.get("overrides", {}),
                     quant_mode=f"psi{conf['quant']['bits']}")
    bad = {k: (getattr(cfg, k), conf["model"][k]) for k in WIDTHS
           if getattr(cfg, k) != conf["model"][k]}
    if bad:
        raise ValueError(f"the port's config differs from the file's model "
                         f"block (port, file): {bad}")
    return cfg


def build_params(conf: Dict, seed: int, device) -> Dict:
    """The serving param tree, in the port's layout."""
    from repro_torch.core.quantizer import is_quantizable, quantize_leaf
    m, q = conf["model"], conf["quant"]
    params: Dict = {"layers": [{} for _ in range(m["n_layers"])]}
    for group in weights.groups(m):
        for name, w in weights.draw(m, seed, group, device).items():
            path = name if group in ("embed", "head") else f"{group}/{name}"
            if is_quantizable(path, w):
                w = quantize_leaf(path, w, q["bits"], q["pack"])
            node, keys = params, path.split("/")
            for k in keys[:-1]:
                node = node[int(k)] if isinstance(node, list) else \
                    node.setdefault(k, {})
            node[keys[-1]] = w
    return params


def check_tree(cfg, params: Dict) -> None:
    """Every leaf the port's model expects is there, at its shape."""
    from repro_torch.models import build_model

    def at(path):
        node = params
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        return node

    for path, shape, _ in build_model(cfg).param_specs():
        got = tuple(at(path).shape)
        if got != tuple(shape):
            raise ValueError(f"leaf {path}: shape {got}, the port wants "
                             f"{tuple(shape)}")


def max_seq(mix: Dict) -> int:
    p = int(mix["prompt"]["max"])
    return -(-p // BUCKET) * BUCKET + int(mix["output"]["max"])


def build_server(conf: Dict, mix: Dict, seed: int, device):
    from repro_torch.launch.serve import Server
    cfg = port_config(conf)
    params = build_params(conf, seed, device)
    check_tree(cfg, params)
    return Server(cfg, params, max_batch=int(mix["slots"]),
                  max_seq=max_seq(mix), device=device,
                  decode_horizon=int(conf["serve"]["decode_horizon"]))


def warm(server, mix: Dict) -> int:
    """The decode graph and one prefill at the mix's shortest bucket (at
    most 64 rows: the PSI kernels' decode route) and its longest (their
    prefill-rows routes), through ``Server.warmup``."""
    from repro_torch.launch.scheduler import Request
    lens = sorted({min(int(mix["prompt"]["min"]), 64),
                   int(mix["prompt"]["max"])})
    reqs = [Request(i, np.zeros((n,), np.int32), 1)
            for i, n in enumerate(lens)]
    return server.warmup(reqs)


def requests(arrivals: List[traffic.Arrival]):
    from repro_torch.launch.scheduler import Request
    return [Request(a.rid, a.prompt, a.max_new, arrival_s=a.arrival_s)
            for a in arrivals]
