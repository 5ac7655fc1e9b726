"""Result files written atomically (temp file + ``os.replace``), so a run
cut off during its end-of-run save cannot leave a torn file."""

from __future__ import annotations

import json
import os


def write_json_atomic(path: str, doc, **dump_kwargs) -> None:
    """JSON result file via temp + ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, **dump_kwargs))
    os.replace(tmp, path)
