"""Start the parallel-layer tests' process groups: `world` processes of
`tests/torch_parallel_worker.py` on the CPU over gloo, one case each."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

WORKER = Path(__file__).with_name("torch_parallel_worker.py")


class Group:
    """`world` ranks running `case` on `directory/inputs.pt` (started at
    once; `results()` waits and returns each rank's output). The ranks meet
    through a file store in `directory` (a TCP port picked here could be
    handed to another group started at the same time)."""

    def __init__(self, case: str, world: int, directory: Path, inputs: dict):
        self.case, self.world, self.dir = case, world, Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, self.dir / "inputs.pt")
        root = str(WORKER.parents[1])
        self.procs = []
        for rank in range(world):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
                   "PARALLEL_TEST_STORE": str(self.dir / "store"),
                   "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   "OMP_NUM_THREADS": "1"}
            self.procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), case, str(self.dir)], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def results(self, timeout: float = 240.0) -> list:
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            logs = [p.communicate()[0] for p in self.procs]
            raise RuntimeError(f"{self.case}: the group of {self.world} did not finish in "
                               f"{timeout} s:\n" + "\n".join(
                                   f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{self.case}: ranks {bad} of {self.world} failed:\n"
                               + "\n".join(f"--- rank {r}\n{logs[r][-4000:]}" for r in bad))
        self.logs = logs
        return [torch.load(self.dir / f"{self.case}.rank{r}.pt", weights_only=False)
                for r in range(self.world)]
