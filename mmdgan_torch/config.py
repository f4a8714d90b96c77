"""Paths of the port (``mmdgan_tpu/config.py:27-28``): where datasets are
read and run folders written. Entry scripts replace the default with
``set_config``; library code takes its folders as arguments."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Config:
    data_dir: str = os.path.expanduser("~/mmdgan_data")
    output_dir: str = os.path.expanduser("~/mmdgan_out")

    def with_updates(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_default_config = Config()


def get_config() -> Config:
    return _default_config


def set_config(cfg: Config) -> None:
    """Replace the process-default config (entry scripts only)."""
    global _default_config
    _default_config = cfg
