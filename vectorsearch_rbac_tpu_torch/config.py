"""Serving configuration and the package logger.

The fields of vectorsearch_rbac_tpu/utils/config.py `FrameworkConfig` that
the ported path reads, with the reference's defaults and the same nesting
(`cfg.search.*`, `cfg.index.*`), so that a reference config object works
here too. The other knobs (HNSW, IVF, optimizer) come with the slices that
read them.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass, field


@dataclass
class SearchConfig:
    topk: int = 10
    batch_size: int = 256        # queries per device dispatch
    block_rows: int = 16384      # arena rows per scan block
    dtype: str = "float32"       # arena dtype: "float32" | "int8"
    wire_dist: str = "u8"        # result wire: the port has "ids" and "f32"


@dataclass
class IndexConfig:
    kind: str = "flat"           # "flat" | "flat_approx"


@dataclass
class FrameworkConfig:
    seed: int = 0
    search: SearchConfig = field(default_factory=SearchConfig)
    index: IndexConfig = field(default_factory=IndexConfig)


_configured = False


def get_logger(name: str) -> logging.Logger:
    """A logger under "vsrbac.torch" with one shared stderr handler; the
    level comes from $VSRBAC_LOG_LEVEL (default INFO)."""
    global _configured
    root = logging.getLogger("vsrbac.torch")
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("VSRBAC_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(f"vsrbac.torch.{name}")
