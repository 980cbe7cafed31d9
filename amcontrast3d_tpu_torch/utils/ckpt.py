"""Checkpoint save / load / resume with latest+best semantics.

↔ ``amcontrast3d_tpu/utils/ckpt.py`` (the contract of
``openpoints/utils/ckpt_util.py:61-183``): every epoch a
``<run>_ckpt_latest`` checkpoint (model, optimizer, epoch, and as extras
``best_val``, ``best_epoch``, the train step's counter ``step`` and the
plateau scheduler's state ``plateau``, all of which a resumed run
restores), copied to ``<run>_ckpt_best`` on a new best validation mIoU, optional
per-``save_freq`` milestone copies.

A checkpoint is one ``torch.save`` file ``{"state": {name: state_dict},
"epoch": …, extras}``; ``state`` names what the caller hands in, as a rule
``{"model": model.state_dict(), "optimizer": optimizer.state_dict()}``.
The JAX package writes flax msgpack, which needs flax (and so jax) to read:
the port reads only its own files.  Weights cross between the packages
through ``utils/convert.py::from_jax_variables``.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(cfg, state: Dict[str, Any], epoch: int,
                    additioanl_dict: Optional[Dict] = None,
                    is_best: bool = False,
                    post_fix: str = "ckpt_latest",
                    save_name: Optional[str] = None) -> str:
    """``state`` is a dict of state_dicts, e.g. ``{"model": …,
    "optimizer": …}``.  Returns the path written."""
    if save_name is None:
        save_name = cfg.run_name
    payload = {"state": state, "epoch": int(epoch)}
    if additioanl_dict is not None:
        payload.update(additioanl_dict)
    path = os.path.join(cfg.ckpt_dir, f"{save_name}_{post_fix}.ckpt")
    torch.save(payload, path)
    if is_best:
        shutil.copyfile(path, os.path.join(cfg.ckpt_dir, f"{save_name}_ckpt_best.ckpt"))
        logging.info("Found the best model and saved in %s", cfg.ckpt_dir)
    save_freq = cfg.get("save_freq", -1) if hasattr(cfg, "get") else -1
    if save_freq is not None and save_freq > 0 and epoch % save_freq == 0:
        shutil.copyfile(path, os.path.join(cfg.ckpt_dir, f"{save_name}_E{epoch}.ckpt"))
    return path


def load_checkpoint(model: torch.nn.Module, pretrained_path: str,
                    module: Optional[str] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> Tuple[Optional[int], Dict]:
    """Load a checkpoint into ``model`` (and ``optimizer`` when given and
    stored).

    Tolerant as the reference (``strict=False``, ckpt_util.py:137-183):
    tensors whose name or shape does not match stay as they are, and both
    lists are logged.  With ``module`` (e.g. ``"encoder"``) only the
    entries of that top-level submodule are taken: the encoder-only
    finetune path.  Returns ``(epoch, extras)``."""
    if not os.path.exists(pretrained_path):
        raise FileNotFoundError(pretrained_path)
    blob = torch.load(pretrained_path, map_location="cpu", weights_only=False)
    if not (isinstance(blob, dict) and isinstance(blob.get("state"), dict)
            and "model" in blob["state"]):
        raise ValueError(
            f"{pretrained_path} is not a checkpoint of this package (a JAX "
            ".ckpt or a reference .pth is not read yet, ROADMAP.md §1)")
    extras = {k: v for k, v in blob.items() if k != "state"}
    stored = blob["state"]["model"]
    own = model.state_dict()
    if module is not None:
        stored = {k: v for k, v in stored.items() if k.startswith(module + ".")}
    take = {k: v for k, v in stored.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    unexpected = sorted(set(stored) - set(take))
    missing = sorted(k for k in own if k not in take
                     and (module is None or k.startswith(module + ".")))
    model.load_state_dict(take, strict=False)
    if optimizer is not None and "optimizer" in blob["state"]:
        optimizer.load_state_dict(blob["state"]["optimizer"])
    if missing:
        logging.info("checkpoint keys kept from init (%d): %s ...",
                     len(missing), missing[:5])
    if unexpected:
        logging.info("checkpoint keys unused (%d): %s ...",
                     len(unexpected), unexpected[:5])
    logging.info("Loaded checkpoint %s (epoch %s, module=%s)",
                 pretrained_path, extras.get("epoch"), module)
    return extras.get("epoch", 0), extras


def resume_checkpoint(cfg, model: torch.nn.Module,
                      optimizer: Optional[torch.optim.Optimizer] = None) -> Dict:
    """Resume training: restore model and optimizer and set
    ``cfg.start_epoch = epoch + 1``.  Returns the extras."""
    epoch, extras = load_checkpoint(model, cfg.pretrained_path,
                                    optimizer=optimizer)
    cfg.start_epoch = int(epoch) + 1
    logging.info("Resume from %s @ epoch %d", cfg.pretrained_path, epoch)
    return extras
