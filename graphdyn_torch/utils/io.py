"""Result files written atomically (temp file + ``os.replace``), so a run
cut off during its end-of-run save cannot leave a torn file."""

from __future__ import annotations

import json
import os

import numpy as np


def write_json_atomic(path: str, doc, **dump_kwargs) -> None:
    """JSON result file via temp + ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, **dump_kwargs))
    os.replace(tmp, path)


def save_results_npz(path: str, **arrays) -> str:
    """Reference-compatible npz result file (the keys are the caller's, as
    in ``graphdyn/utils/io.py:save_results_npz``), written atomically:
    ``np.savez`` to a temporary name, then ``os.replace``. Like ``np.savez``
    it appends ``.npz`` to a path without it; returns the final path."""
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, final)
    return final
