"""The port's logger and an environment snapshot (after
`htd_tpu/utils/logger.py`; mmdet's utils/logger.py and collect_env)."""

from __future__ import annotations

import logging
import os
import platform
import subprocess
import sys
from typing import Optional

import torch

from htd_tpu_torch.parallel.dist import world

_NAME = "htd_tpu_torch"


class _Stdout(logging.StreamHandler):
    """A stream handler on whatever `sys.stdout` is at each record."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _):
        pass


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The package's logger: a stream handler on stdout, and on rank 0 (of
    `torch.distributed`'s default group, or the only process) a file
    handler on `log_file`, which a call with another `log_file` replaces
    (one process may run several tools in turn). The other ranks log
    errors only, as mmdet's logger does, so that a multi-process run prints
    and writes each line once."""
    logger = logging.getLogger(_NAME)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        logger.propagate = False
        sh = _Stdout()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    rank, _ = world()
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    if log_file and rank == 0:
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def collect_env() -> dict:
    """Python, platform, torch and CUDA versions, the card's name and power
    limit (`nvidia-smi`) when a card is there, the device count and the
    world size."""
    info = {"python": sys.version.split()[0], "platform": platform.platform(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
            "world_size": world()[1]}
    if info["device_count"]:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        info["gpu"] = out.stdout.strip().splitlines()
    return info
