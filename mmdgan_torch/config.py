"""Paths of the port (``mmdgan_tpu/config.py:27-29``): where datasets are
read, run folders written and the frozen inception graph found. Entry
scripts replace the default with ``set_config``; library code takes its
folders as arguments."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    data_dir: str = os.path.expanduser("~/mmdgan_data")
    output_dir: str = os.path.expanduser("~/mmdgan_out")
    inception_pb: Optional[str] = None   # frozen inception graph for IS/FID

    def with_updates(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_default_config = Config()


def get_config() -> Config:
    return _default_config


def set_config(cfg: Config) -> None:
    """Replace the process-default config (entry scripts only)."""
    global _default_config
    _default_config = cfg
