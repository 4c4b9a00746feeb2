"""Thin YAML/JSON read/write wrappers (the port's own copy of
``fpyv_tpu.io.files``).

Parity: src/utils/yaml_helper.py:4-12 and src/utils/json_helper.py:4-11.
All paths are caller-supplied. ``yaml`` is imported where it is used, so
the port imports on a machine without PyYAML as long as no YAML is read.
"""

from __future__ import annotations

import json
from pathlib import Path


def yaml_reader(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def yaml_writer(path, data) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(data, f)


def json_reader(path):
    with open(path) as f:
        return json.load(f)


def json_writer(data, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)
