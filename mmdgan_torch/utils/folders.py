"""Run-folder layout (``mmdgan_tpu/utils/folders.py``, the reference's
``prepare_folder``, graph_func.py:161-180):

  {out}/{filename}_ckpt/{sub_folder}/   checkpoints
  {out}/{filename}_log/{sub_folder}/    summaries
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def prepare_folder(filename: str, sub_folder: str = "",
                   set_folder: Optional[str] = None) -> Tuple[str, str, str]:
    """Returns (ckpt_folder, summary_folder, save_path_prefix)."""
    if set_folder is None:
        from mmdgan_torch.config import get_config
        set_folder = get_config().output_dir
    ckpt_folder = os.path.join(set_folder, f"{filename}_ckpt", sub_folder)
    summary_folder = os.path.join(set_folder, f"{filename}_log", sub_folder)
    os.makedirs(ckpt_folder, exist_ok=True)
    os.makedirs(summary_folder, exist_ok=True)
    save_path = os.path.join(ckpt_folder, f"{filename}.ckpt")
    return ckpt_folder, summary_folder, save_path
