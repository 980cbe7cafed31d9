"""EasyConfig: YAML config tree with attribute access, recursive
``default.yaml`` inheritance and dotted CLI overrides.

Accepts the reference's ``cfgs/*.yaml`` files unchanged (contract defined by
``openpoints/utils/config.py:18-113``): ``load(path, recursive=True)`` walks up
the directory tree merging every ``default.yaml`` from the root down, then the
leaf file; ``update([...])`` applies ``key=value`` / ``key.sub=value`` CLI
overrides with ``ast.literal_eval`` coercion.
"""
from __future__ import annotations

import hashlib
import json
import os
from ast import literal_eval
from typing import Any, Dict, List, Tuple, Union

import yaml


class EasyConfig(dict):
    def __getattr__(self, key: str) -> Any:
        if key not in self:
            raise AttributeError(key)
        return self[key]

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]

    def load(self, fpath: str, *, recursive: bool = False) -> None:
        if not os.path.exists(fpath):
            raise FileNotFoundError(fpath)
        fpaths = [fpath]
        if recursive:
            extension = os.path.splitext(fpath)[1]
            while os.path.dirname(fpath) != fpath:
                fpath = os.path.dirname(fpath)
                fpaths.append(os.path.join(fpath, "default" + extension))
        for fp in reversed(fpaths):
            if os.path.exists(fp):
                with open(fp) as f:
                    loaded = yaml.safe_load(f)
                if loaded is not None:
                    self.update(loaded)

    def reload(self, fpath: str, *, recursive: bool = False) -> None:
        self.clear()
        self.load(fpath, recursive=recursive)

    def update(self, other: Union[Dict, List, Tuple]) -> None:  # type: ignore[override]
        if isinstance(other, (list, tuple)):
            self._update_from_opts(other)
        else:
            self._update_from_dict(other)

    def _update_from_dict(self, other: Dict) -> None:
        for key, value in other.items():
            if isinstance(value, dict):
                if key not in self or not isinstance(self[key], EasyConfig):
                    self[key] = EasyConfig()
                self[key]._update_from_dict(value)
            else:
                self[key] = value

    def _update_from_opts(self, opts: Union[List, Tuple]) -> None:
        index = 0
        while index < len(opts):
            opt = opts[index]
            if opt.startswith("--"):
                opt = opt[2:]
            if "=" in opt:
                key, value = opt.split("=", 1)
                index += 1
            else:
                key, value = opt, opts[index + 1]
                index += 2
            try:
                value = literal_eval(value)
            except Exception:
                pass
            current = self
            subkeys = key.split(".")
            for subkey in subkeys[:-1]:
                current = current.setdefault(subkey, EasyConfig())
            leaf = subkeys[-1]
            # Guard boolean flags against truthy-string typos: a misspelt
            # override like remat=Flase would otherwise land as the string
            # "Flase" and silently read as True.
            if (isinstance(value, str) and leaf in current
                    and isinstance(current[leaf], bool)):
                lowered = value.strip().lower()
                if lowered in ("true", "yes", "1"):
                    value = True
                elif lowered in ("false", "no", "0"):
                    value = False
                else:
                    raise ValueError(
                        f"override {key}={value!r}: existing value is a "
                        f"bool; expected true/false")
            current[leaf] = value

    def dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self.items():
            if isinstance(value, EasyConfig):
                value = value.dict()
            out[key] = value
        return out

    def hash(self) -> str:
        buffer = json.dumps(self.dict(), sort_keys=True, default=str)
        return hashlib.sha256(buffer.encode()).hexdigest()

    def __str__(self) -> str:
        texts = []
        for key, value in self.items():
            sep = "\n" if isinstance(value, EasyConfig) else " "
            text = key + ":" + sep + str(value)
            lines = text.split("\n")
            for k, line in enumerate(lines[1:]):
                lines[k + 1] = "  " + line
            texts.extend(lines)
        return "\n".join(texts)
