"""The card's power draw and SM clock beside the window, from ``nvidia-smi``
every half second (read only; nothing is set).  Printed on its own line,
never as a metric."""
from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple


class PowerSampler:
    def __init__(self, index: int = 0, period_ms: int = 500):
        self.cmd = ["nvidia-smi", "-i", str(index),
                    "--query-gpu=power.draw,clocks.sm",
                    "--format=csv,noheader,nounits", "-lms", str(period_ms)]
        self.index = index
        self.samples: List[Tuple[float, float, float]] = []
        self.proc = None
        self.thread = None

    def start(self) -> None:
        if shutil.which("nvidia-smi") is None:
            return
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                draw, sm = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), draw, sm))

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)
        self.proc.stdout.close()

    def summary(self, t_from: float, t_to: float) -> Dict:
        got = [s for s in self.samples if t_from <= s[0] < t_to]
        if not got:
            return {"samples": 0, "power_draw_w": "not measured"}
        draw = [s[1] for s in got]
        sm = [s[2] for s in got]
        out = {"samples": len(got),
               "power_draw_w": {"mean": sum(draw) / len(draw),
                                "min": min(draw), "max": max(draw)},
               "clocks_sm_mhz": {"mean": sum(sm) / len(sm),
                                 "min": min(sm), "max": max(sm)}}
        try:
            out["power_limit_w"] = float(subprocess.run(
                ["nvidia-smi", "-i", str(self.index),
                 "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30).stdout.strip())
        except (OSError, ValueError, subprocess.TimeoutExpired):
            out["power_limit_w"] = "not measured"
        return out
