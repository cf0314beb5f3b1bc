"""End-to-end training entry point of the port: QAT (``--quant qat5|qat8``,
the paper's training with the quantizer in the loop), AdamW with the
cosine schedule and the global-norm clip, optional int8 error-feedback
gradient compression, checkpoints with exact data-stream resume, and the
straggler monitor.  Eager PyTorch: every product of a float weight is a
plain ``torch.matmul`` of its fake-quantized copy (the JAX package
computes QAT outside its kernels too).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --steps 20 --quant qat8 --device cpu --ckpt-dir /tmp/ck

Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import TokenStream, make_batch_for
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.core.quantizer import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import (compress_gradients,
                                        decompress_gradients)
from repro_torch.runtime.straggler import StragglerMonitor


def make_train_step(model, opt, compress: bool = False):
    """``step(params, opt_state, err_fb, batch)`` -> (params, opt_state,
    err_fb, metrics): the loss and its gradients (``torch.autograd.grad``
    over every leaf of ``params``, float tensors all; a leaf the loss does
    not reach gets zeros, as JAX gives), optionally compressed and
    decompressed with error feedback, then ``opt.update`` (in place)."""
    def train_step(params, opt_state, err_fb, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, met = model.loss(params, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)])
        del got
        grads = tree_map(lambda _: next(it), params)
        if compress:
            comp, err_fb = compress_gradients(grads, err_fb)
            grads = decompress_gradients(comp)
            del comp
        params, opt_state, om = opt.update(grads, opt_state, params)
        del grads
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in met.items()}, **om}
        return params, opt_state, err_fb, metrics

    return train_step


def make_sharded_train_step(model, opt, share, compress: bool = False):
    """The train step on a mesh (``runtime.fsdp.TrainShare``), the twin of
    the JAX package's dry-run step (params, m and v on the train specs,
    the batch on ``batch_specs``): ``step(params, opt_state, batch)`` ->
    (params, opt_state, metrics) with params, ``m`` and ``v`` this rank's
    chunks and ``batch`` its rows (``share.local_batch``).  The whole
    params are gathered on use, the loss over the rank's rows is scaled
    by 1 / mesh size so the gradients that reduce back to each chunk are
    those of the global mean, ``opt.update`` runs on the chunks with the
    global norm, in place.  The metrics' losses are global means (an MoE
    model's load-balancing loss is taken over the global batch:
    ``runtime.fsdp.BatchSum``)."""
    if compress:
        raise NotImplementedError(
            "gradient compression on a mesh is not ported (ROADMAP queue 1, "
            "item 1: the JAX package's sharded step has none)")
    moe = model.cfg.family == "moe"

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        full = share.gather_params(params)
        if moe:
            # the router's load-balance means over the global batch
            batch_sum = share.batch_sum()
            if batch_sum is not None:
                full["layers"] = [dict(layer, moe=dict(layer["moe"],
                                                       batch_sum=batch_sum))
                                  for layer in full["layers"]]
        loss, met = model.loss(full, batch)
        del full
        got = torch.autograd.grad(loss / share.size, leaves,
                                  allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)])
        del got
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = opt.update(
            grads, opt_state, params, grad_norm=share.global_norm(grads))
        del grads
        metrics = {"loss": share.mean(loss),
                   **{k: share.mean(v) for k, v in met.items()}, **om}
        return params, opt_state, metrics

    return train_step


def train(cfg, steps: int, ckpt_dir=None, seed: int = 0,
          compress: bool = False, save_every: int = 50, log_every: int = 10,
          batch_size: int = 8, seq_len: int = 128, device=None,
          params=None, on_step=None, held_out=None):
    """Train ``cfg`` for ``steps`` steps on ``device`` (CUDA unless the
    caller names another) from ``params`` (default ``Model.init(seed)``),
    resuming from the latest checkpoint in ``ckpt_dir`` when there is one
    (params, optimizer state and the stream's state).  Returns (params,
    the losses of the steps run).  ``on_step(info)`` receives each step's
    {"step", "loss", "lr", "wall_ms", "device_ms"} (device_ms from CUDA
    events on the card, None on the CPU).  ``held_out`` (a batch): its
    loss is printed before the first step run and after the last."""
    device = resolve_device(device)
    model = build_model(cfg)
    opt = adamw(lr=cosine_schedule(3e-4, max(steps // 10, 1), steps))
    if params is None:
        params = model.init(seed, device)
    opt_state = opt.init(params)
    err_fb = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
              if compress else {})
    stream = TokenStream(cfg.vocab_size, seq_len, batch_size, seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, extra = mgr.restore(device=device)
        params, opt_state = state["params"], _restore_opt(state["opt"])
        stream.load_state_dict(extra["data"])
        start = extra["step"]
        print(f"resumed from step {start}")

    if held_out is not None:
        before = _eval_loss(model, params, held_out)
    step_fn = make_train_step(model, opt, compress)
    monitor = StragglerMonitor(n_hosts=1)
    cuda = device.type == "cuda"
    history = []
    for step in range(start, steps):
        toks = next(stream)
        gen = torch.Generator(device=device)
        gen.manual_seed(step)
        batch = make_batch_for(cfg, batch_size, seq_len, gen)
        batch["tokens"] = torch.from_numpy(toks).to(device)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        params, opt_state, err_fb, metrics = step_fn(
            params, opt_state, err_fb, batch)
        if cuda:
            ev[1].record()
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.observe([dt])
        history.append(loss)
        if on_step is not None:
            on_step({"step": step, "loss": loss, "lr": metrics["lr"],
                     "wall_ms": dt * 1e3,
                     "device_ms": (ev[0].elapsed_time(ev[1]) if cuda
                                   else None)})
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms, lr {metrics['lr']:.2e})")
        if mgr and (step + 1) % save_every == 0:
            mgr.save(step + 1,
                     {"params": params, "opt": _opt_tree(opt_state)},
                     extra={"step": step + 1, "data": stream.state_dict()},
                     blocking=False)
    if held_out is not None:
        print(f"held-out loss {before:.4f} -> "
              f"{_eval_loss(model, params, held_out):.4f}")
    if mgr:
        mgr.save(steps, {"params": params, "opt": _opt_tree(opt_state)},
                 extra={"step": steps, "data": stream.state_dict()})
        mgr.wait()
    return params, history


def _eval_loss(model, params, batch) -> float:
    with torch.no_grad():
        return float(model.loss(params, batch)[0])


def _opt_tree(s: AdamWState):
    """The optimizer state as the JAX package writes it: the step an int32
    scalar, the moments as trees."""
    return {"step": torch.tensor(s.step, dtype=torch.int32), "m": s.m,
            "v": s.v}


def _restore_opt(tree) -> AdamWState:
    return AdamWState(step=int(tree["step"]), m=tree["m"], v=tree["v"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--quant", default="none",
                    choices=["none", "qat5", "qat8"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, quant_mode=args.quant)
    if args.reduced:
        cfg = reduced_config(cfg, quant_mode=args.quant)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    device = resolve_device(args.device)
    # a batch no step draws (another seed of the stream): over a short
    # run the loss of each step's fresh batch moves less than the spread
    # between batches
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    held_out = make_batch_for(cfg, args.batch, args.seq, gen)
    held_out["tokens"] = torch.from_numpy(next(TokenStream(
        cfg.vocab_size, args.seq, args.batch, seed=1))).to(device)
    _, history = train(cfg, args.steps, ckpt_dir=args.ckpt_dir,
                       compress=args.compress_grads,
                       batch_size=args.batch, seq_len=args.seq,
                       device=device, held_out=held_out)
    if history:
        print(f"final loss {history[-1]:.4f} (from {history[0]:.4f})")
    return history


if __name__ == "__main__":
    main()
