"""Name → class registry used by every layer of the framework.

Mirrors the registry contract of the reference
(``openpoints/utils/registry.py:8-294``): modules register under their class
name (or an alias), and ``build(cfg)`` instantiates ``cfg.NAME`` with the
remaining keys of ``cfg`` (plus extra kwargs) as constructor arguments.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def _register(self, module: Any, name: Optional[str] = None, force: bool = False):
        if name is None:
            name = module.__name__
        names = [name] if isinstance(name, str) else list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = module

    def register_module(self, name: Optional[str] = None, module: Optional[Any] = None,
                        force: bool = False) -> Callable:
        """Use as ``@REG.register_module()`` or ``REG.register_module(name=..., module=...)``."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def build(self, cfg: Dict, **extra_kwargs) -> Any:
        """Instantiate ``cfg.NAME`` with the remaining config keys as kwargs.

        ``cfg`` is not mutated.  Mirrors ``Registry.build_from_cfg``
        (reference ``openpoints/utils/registry.py:248-294``).
        """
        if cfg is None:
            raise ValueError(f"cannot build from empty cfg in registry {self._name}")
        if isinstance(cfg, str):
            kwargs = dict(extra_kwargs)
            name = cfg
        else:
            kwargs = {k: v for k, v in dict(cfg).items() if k != "NAME"}
            kwargs.update(extra_kwargs)
            name = cfg.get("NAME") if hasattr(cfg, "get") else cfg["NAME"]
        if name is None:
            raise KeyError(f"cfg for registry {self._name} has no NAME: {cfg}")
        module = self._module_dict.get(name)
        if module is None:
            raise KeyError(f"{name} is not registered in {self._name}; "
                           f"available: {sorted(self._module_dict)}")
        if inspect.isfunction(module):
            return module(**kwargs)
        return module(**kwargs)
