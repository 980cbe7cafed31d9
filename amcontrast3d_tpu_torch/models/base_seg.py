"""Segmentation model wrappers.

↔ ``amcontrast3d_tpu/models/base_seg.py``:

* ``BaseSeg``              — vanilla PointNeXt: logits only.
* ``BaseSeg_AMContrast3D`` — also returns the per-stage embeddings the
  adaptive-margin contrastive loss consumes, as a dict of dense per-stage
  tensors: ``p`` (stage positions (B, N_s, 3), s = 1…4), ``f_down``
  (encoder features) and ``f_up`` (decoder features), and ``clouds``, the
  layouts of ``p`` that the encoder sorted once for the forward's kernels
  (``ops.spatial.sort_stages``), which the loss reads instead of sorting.
* ``BaseSeg_M_AMContrast3D`` — AMContrast3D++: an APM predicts each
  stage's ambiguity from the encoder's positions and features, the decoder
  refines its high-ambiguity features with it (at inference too), and the
  stages also carry ``ambiguity``; returns ``(logits, stages, refine
  rate)``.

``dtype`` (the runner's ``use_amp``) goes to the encoder, the decoder, the
head and the APM, as the JAX models hand it on; the logits come out in it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from .build import MODELS, make_module
from .pointnext import PointNextDecoder, PointNextEncoder, SegHead


def _build_encoder(encoder_args, dtype):
    ea = dict(encoder_args)
    cls = MODELS.get(ea.pop("NAME", "PointNextEncoder")) or PointNextEncoder
    return make_module(cls, ea, dtype=dtype)


def _build_decoder(encoder_args, decoder_args, encoder, dtype, **extra):
    """Merge encoder args into decoder args (base_seg.py:102-106)."""
    merged = dict(encoder_args)
    merged.update(dict(decoder_args or {}))
    merged.pop("NAME", None)
    name = dict(decoder_args or {}).get("NAME", "PointNextDecoder")
    # the AMContrast3D decoder aliases resolve to PointNextDecoder
    cls = PointNextDecoder if name.startswith("PointNextDecoder") \
        else (MODELS.get(name) or PointNextDecoder)
    merged["encoder_channel_list"] = encoder.channel_list
    merged["in_channels_input"] = dict(encoder_args).get("in_channels", 3)
    return make_module(cls, merged, dtype=dtype, **extra)


def _build_head(cls_args, decoder, encoder, dtype):
    ca = dict(cls_args)
    ca.pop("NAME", None)
    if getattr(decoder, "out_channels", None) is not None:
        ca["in_channels"] = decoder.out_channels
    elif getattr(encoder, "out_channels", None) is not None:
        ca["in_channels"] = encoder.out_channels
    return make_module(SegHead, ca, dtype=dtype)


@MODELS.register_module()
class BaseSeg(nn.Module):
    def __init__(self, encoder_args, decoder_args=None, cls_args=None,
                 dtype=None):
        super().__init__()
        self.encoder = _build_encoder(encoder_args, dtype)
        self.decoder = (_build_decoder(encoder_args, decoder_args, self.encoder,
                                       dtype)
                        if decoder_args is not None else None)
        self.head = (_build_head(cls_args, self.decoder, self.encoder, dtype)
                     if cls_args is not None else None)

    def forward(self, pos: torch.Tensor, features: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, f = self.encoder(pos, features)
        f = self.decoder(p, f)[0] if self.decoder is not None else f[-1]
        return self.head(f, generator) if self.head is not None else f


@MODELS.register_module()
class BaseSeg_AMContrast3D(nn.Module):
    """Returns ``(logits, stages)``."""

    def __init__(self, encoder_args, decoder_args=None, cls_args=None,
                 dtype=None):
        super().__init__()
        self.encoder = _build_encoder(encoder_args, dtype)
        self.decoder = _build_decoder(encoder_args, decoder_args or {},
                                      self.encoder, dtype)
        self.head = _build_head(cls_args, self.decoder, self.encoder, dtype)

    def forward(self, pos: torch.Tensor, features: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        sampled = self.encoder.sample(pos)
        p, f = self.encoder(pos, features, sampled)
        f_out, up_features, _ = self.decoder(p, f, clouds=sampled.clouds)
        logits = self.head(f_out, generator)
        n = len(up_features)
        stages = {"p": tuple(p[1:1 + n]), "f_down": tuple(f[1:1 + n]),
                  "f_up": tuple(up_features),
                  "clouds": tuple(sampled.clouds[1:1 + n])}
        return logits, stages


@MODELS.register_module()
class BaseSeg_M_AMContrast3D(nn.Module):
    """Returns ``(logits, stages, refine rate)``.

    ``AEF_args.source`` picks the ambiguity that drives the refinement:
    'APM' the predicted one (also at inference, the default), 'AEF' the
    ground truth from the labels (training only): computed here when
    ``target`` is given, or passed in as ``aef_ambiguity``."""

    def __init__(self, encoder_args, decoder_args=None, cls_args=None,
                 AEF_args: Any = None, APM_args: Any = None, dtype=None):
        super().__init__()
        apm = dict(APM_args or {})
        self.linear_mapping = bool(apm.get("linear_mapping", False))
        self.aef_args = dict(AEF_args or {})
        self.num_classes = int(dict(cls_args)["num_classes"])
        self.ignore_index = dict(cls_args).get("ignore_index")
        self.encoder = _build_encoder(encoder_args, dtype)
        self.decoder = _build_decoder(
            encoder_args, decoder_args, self.encoder, dtype, refine=True,
            refine_mapping=self.linear_mapping,
            refine_attention=bool(apm.get("cross_attention", False)),
            nsample_k=int(apm.get("nsample_k", 12)),
            fusion=apm.get("fusion", "MIN"),
            threshold=float(apm.get("threshold", 0.7)),
            threshold_max=float(apm.get("threshold_max", 1.0)),
            gamma=float(apm.get("gamma", 0.5)))
        self.head = _build_head(cls_args, self.decoder, self.encoder, dtype)
        name = apm.get("NAME", "APM_pf_ConCate")
        apm_cls = MODELS.get(name)
        if apm_cls is None:
            raise KeyError(f"APM {name} not registered")
        self.APM = make_module(apm_cls, apm, dtype=dtype)

    def forward(self, pos: torch.Tensor, features: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                target: Optional[torch.Tensor] = None, aef_ambiguity=None):
        sampled = self.encoder.sample(pos)
        p, f = self.encoder(pos, features, sampled)
        clouds = sampled.clouds
        n = self.decoder.decoder_stages
        a_list, a_map_list = [], []
        for i in range(1, 1 + n):
            out = self.APM(p[i], f[i], stage=i - 1, generator=generator)
            if self.linear_mapping:
                out, a_map = out
                a_map_list.append(a_map)
            a_list.append(out[..., 0])                           # (B, N_s)
        if (aef_ambiguity is None and target is not None
                and self.aef_args.get("source") == "AEF"):
            from ..loss.contrast import ambiguity_head
            aef_ambiguity = ambiguity_head(
                [(p[i], f[i]) for i in range(1, 1 + n)], target,
                self.num_classes, self.ignore_index, self.aef_args,
                clouds=clouds[1:1 + n])
        f_out, up_features, refine_rate = self.decoder(
            p, f, a_list=a_list if aef_ambiguity is None else aef_ambiguity,
            a_map_list=a_map_list if self.linear_mapping else None,
            clouds=clouds)
        logits = self.head(f_out, generator)
        stages = {"p": tuple(p[1:1 + n]), "f_down": tuple(f[1:1 + n]),
                  "f_up": tuple(up_features), "ambiguity": tuple(a_list),
                  "clouds": tuple(clouds[1:1 + n])}
        return logits, stages, refine_rate


# registry aliases for the reference encoder/decoder names
MODELS.register_module(name=["PointNextEncoder", "PointNextEncoder_AMContrast3D",
                             "PointNextEncoder_M_AMContrast3D"],
                       module=PointNextEncoder)
MODELS.register_module(name=["PointNextDecoder", "PointNextDecoder_AMContrast3D",
                             "PointNextDecoder_M_AMContrast3D"],
                       module=PointNextDecoder)
MODELS.register_module(module=SegHead)
