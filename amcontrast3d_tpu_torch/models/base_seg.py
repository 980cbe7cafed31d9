"""Segmentation model wrappers.

↔ ``amcontrast3d_tpu/models/base_seg.py``:

* ``BaseSeg``              — vanilla PointNeXt: logits only.
* ``BaseSeg_AMContrast3D`` — also returns the per-stage embeddings the
  adaptive-margin contrastive loss consumes, as a dict of dense per-stage
  tensors: ``p`` (stage positions (B, N_s, 3), s = 1…4), ``f_down``
  (encoder features) and ``f_up`` (decoder features).
"""
from __future__ import annotations

import torch
from torch import nn

from .build import MODELS, make_module
from .pointnext import PointNextDecoder, PointNextEncoder, SegHead


def _build_encoder(encoder_args):
    ea = dict(encoder_args)
    cls = MODELS.get(ea.pop("NAME", "PointNextEncoder")) or PointNextEncoder
    return make_module(cls, ea)


def _build_decoder(encoder_args, decoder_args, encoder):
    """Merge encoder args into decoder args (base_seg.py:102-106)."""
    merged = dict(encoder_args)
    merged.update(dict(decoder_args))
    merged.pop("NAME", None)
    name = dict(decoder_args).get("NAME", "PointNextDecoder")
    # the AMContrast3D decoder aliases resolve to PointNextDecoder
    cls = PointNextDecoder if name.startswith("PointNextDecoder") \
        else (MODELS.get(name) or PointNextDecoder)
    merged["encoder_channel_list"] = encoder.channel_list
    merged["in_channels_input"] = dict(encoder_args).get("in_channels", 3)
    return make_module(cls, merged)


def _build_head(cls_args, decoder, encoder):
    ca = dict(cls_args)
    ca.pop("NAME", None)
    if getattr(decoder, "out_channels", None) is not None:
        ca["in_channels"] = decoder.out_channels
    elif getattr(encoder, "out_channels", None) is not None:
        ca["in_channels"] = encoder.out_channels
    return make_module(SegHead, ca)


@MODELS.register_module()
class BaseSeg(nn.Module):
    def __init__(self, encoder_args, decoder_args=None, cls_args=None):
        super().__init__()
        self.encoder = _build_encoder(encoder_args)
        self.decoder = (_build_decoder(encoder_args, decoder_args, self.encoder)
                        if decoder_args is not None else None)
        self.head = (_build_head(cls_args, self.decoder, self.encoder)
                     if cls_args is not None else None)

    def forward(self, pos: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        p, f = self.encoder(pos, features)
        f = self.decoder(p, f)[0] if self.decoder is not None else f[-1]
        return self.head(f) if self.head is not None else f


@MODELS.register_module()
class BaseSeg_AMContrast3D(nn.Module):
    """Returns ``(logits, stages)``."""

    def __init__(self, encoder_args, decoder_args=None, cls_args=None):
        super().__init__()
        self.encoder = _build_encoder(encoder_args)
        self.decoder = _build_decoder(encoder_args, decoder_args or {},
                                      self.encoder)
        self.head = _build_head(cls_args, self.decoder, self.encoder)

    def forward(self, pos: torch.Tensor, features: torch.Tensor):
        p, f = self.encoder(pos, features)
        f_out, up_features = self.decoder(p, f)
        logits = self.head(f_out)
        n = len(up_features)
        stages = {"p": tuple(p[1:1 + n]), "f_down": tuple(f[1:1 + n]),
                  "f_up": tuple(up_features)}
        return logits, stages


# registry aliases for the reference encoder/decoder names
MODELS.register_module(name=["PointNextEncoder", "PointNextEncoder_AMContrast3D",
                             "PointNextEncoder_M_AMContrast3D"],
                       module=PointNextEncoder)
MODELS.register_module(name=["PointNextDecoder", "PointNextDecoder_AMContrast3D",
                             "PointNextDecoder_M_AMContrast3D"],
                       module=PointNextDecoder)
MODELS.register_module(module=SegHead)
