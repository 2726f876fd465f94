"""Between the JAX package's outputs (as numpy arrays) and the port's
tensors, so that both pipelines can be fed and compared like for like."""

from __future__ import annotations

import numpy as np
import torch

from urban_road_filter_torch.config import FilterConfig
from urban_road_filter_torch.ops.geometry import RingLayout


def filter_config(cfg) -> FilterConfig:
    """The port's FilterConfig from any object with ``to_dict()`` (the JAX
    package's FilterConfig, or the port's own), every field kept."""
    return FilterConfig.from_dict(cfg.to_dict())


def layout_from_numpy(layout, device="cpu") -> RingLayout:
    """The port's RingLayout from any object with the JAX RingLayout's
    fields in its order (arrays np.asarray can read), dtypes kept."""
    return RingLayout(*(torch.from_numpy(np.array(f)).to(device)
                        for f in layout))


def to_numpy(result):
    """A NamedTuple of tensors (ScanResult, RingLayout) as the same
    NamedTuple of host numpy arrays."""
    return type(result)(*(t.detach().cpu().numpy() for t in result))
