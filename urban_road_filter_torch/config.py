"""Configuration schema of the urban road filter.

The port's own copy of urban_road_filter_tpu/config.py, behaviour kept,
so that the port imports nothing of the JAX package.

This mirrors the reference node's dynamic_reconfigure schema
(reference: cfg/LidarFilters.cfg:10-86) — same parameter names (snake_case),
defaults and ranges.  The cfg file is the source of truth for defaults
(e.g. ``poly_s_param`` defaults to 0.7 from the cfg, not the 0.5 hardcoded in
lidar_segmentation.cpp:20 — the cfg wins at node startup).

Unlike the reference's 28 racy mutable globals (data_structures.hpp:66-88,
written without synchronization from the reconfigure thread, main.cpp:4-34),
the config here is one immutable, hashable dataclass.  The jitted pipeline
treats it as a static argument: swapping config between scans re-traces
(compilation is cached per distinct config), which is the functional
equivalent of live reconfiguration without the data race.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping, NamedTuple

__all__ = [
    "FilterConfig",
    "PipelineDims",
    "PARAM_RANGES",
    "StaticConfig",
    "DynConfig",
    "RunConfig",
    "device_config",
    "param_buffer",
]

# Valid ranges, straight from cfg/LidarFilters.cfg (min, max).
PARAM_RANGES: Mapping[str, tuple[float, float]] = {
    "x_direction": (0, 2),
    "interval": (0.01, 10.0),
    "curb_height": (0.01, 0.5),
    "curb_points": (1, 30),
    "beam_zone": (10.0, 100.0),
    "min_x": (-200.0, 200.0),
    "max_x": (-200.0, 200.0),
    "min_y": (-200.0, 200.0),
    "max_y": (-200.0, 200.0),
    "min_z": (-200.0, 200.0),
    "max_z": (-200.0, 200.0),
    "cylinder_deg_x": (0.0, 180.0),
    "cylinder_deg_z": (0.0, 180.0),
    "curb_slope_deg": (0.0, 180.0),
    "kdev_param": (0.5, 5.0),
    "kdist_param": (0.4, 10.0),
    "dmin_param": (3, 30),
    "poly_s_param": (0.0, 1.0),
    "poly_z_manual": (-5.0, 5.0),
    "probably_road_ring": (0, 1024),
}


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """All 28 reference parameters (cfg/LidarFilters.cfg names & defaults)."""

    # Frame / topic (host-side metadata; no effect on device compute).
    fixed_frame: str = "left_os1/os1_lidar"
    topic_name: str = "/left_os1/os1_cloud_node/points"

    # Detection method toggles (cfg:16-19).
    x_zero_method: bool = True
    z_zero_method: bool = True
    star_shaped_method: bool = True
    blind_spots: bool = True

    # Blind-spot x-direction enum: 0 = both X, 1 = +X only, 2 = -X only (cfg:23-27).
    x_direction: int = 0

    # LiDAR vertical angular-resolution tolerance, degrees (cfg:30).
    interval: float = 0.18

    # Minimum curb height in metres / estimated points on a curb (cfg:33-36).
    curb_height: float = 0.05
    curb_points: int = 5

    # Width of the examined beam zone, degrees (cfg:39).
    beam_zone: float = 30.0

    # ROI crop box (cfg:42-51).
    min_x: float = 0.0
    max_x: float = 30.0
    min_y: float = -10.0
    max_y: float = 10.0
    min_z: float = -3.0
    max_z: float = -1.0

    # Angle thresholds: x-zero triangle angle, z-zero vector angle,
    # star-shaped radial slope, degrees (cfg:54-60).
    cylinder_deg_x: float = 150.0
    cylinder_deg_z: float = 140.0
    curb_slope_deg: float = 50.0

    # Star-shaped adaptive-threshold coefficients (cfg:63-72).
    kdev_param: float = 1.225
    kdist_param: float = 2.0
    starbeam_filter: bool = False
    dmin_param: int = 10

    # Polygon simplification & z handling (cfg:75-84).
    simple_poly_allow: bool = True
    poly_s_param: float = 0.7
    poly_z_manual: float = -1.5
    poly_z_avg_allow: bool = True

    # Which ring the road_probably topic dumps verbatim.  The reference
    # hardcodes ring 10 (lidar_segmentation.cpp:605-608); this knob is our
    # extension (SURVEY.md section 7 non-goals) — no cfg/LidarFilters.cfg
    # counterpart.
    probably_road_ring: int = 10

    def __post_init__(self) -> None:
        for name, (lo, hi) in PARAM_RANGES.items():
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(f"{name}={v} outside valid range [{lo}, {hi}]")
        if self.min_x > self.max_x or self.min_y > self.max_y or self.min_z > self.max_z:
            raise ValueError("ROI box is empty (min > max)")

    # ---- convenience accessors using the reference's internal names ----
    @property
    def angle_filter1(self) -> float:  # x-zero threshold (x_zero_method.cpp:3)
        return self.cylinder_deg_x

    @property
    def angle_filter2(self) -> float:  # z-zero threshold (z_zero_method.cpp:3)
        return self.cylinder_deg_z

    @property
    def angle_filter3(self) -> float:  # star-shaped slope, deg (star_shaped_search.cpp:11)
        return self.curb_slope_deg

    # ---- serialization ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FilterConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def replace(self, **kw: Any) -> "FilterConfig":
        """Hot-swap parameters between scans (dynamic_reconfigure equivalent)."""
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FilterConfig":
        return cls.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    @classmethod
    def from_yaml(cls, s: str) -> "FilterConfig":
        """Load from YAML — the rosparam-file equivalent (the reference is
        configured via launch-file params + cfg/LidarFilters.cfg)."""
        import yaml

        d = yaml.safe_load(s)
        if not isinstance(d, Mapping):
            raise ValueError("config YAML must be a mapping of parameters")
        return cls.from_dict(d)

    @classmethod
    def from_file(cls, path: str) -> "FilterConfig":
        """Load from a .json or .yaml/.yml file by extension."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            return cls.from_yaml(text)
        return cls.from_json(text)

    def config_hash(self) -> str:
        import hashlib

        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    # ---- derived trace constants (host float64, like the C++ double
    # intermediates; see ops/xzero.py / ops/star.py for the exact forms) ----
    @property
    def cos_x(self):
        """cos(angleFilter1): x-zero threshold moved to cosine space."""
        import numpy as np

        return np.float32(math.cos(math.radians(float(np.float32(self.cylinder_deg_x)))))

    @property
    def cos_z(self):
        """cos(angleFilter2): z-zero threshold in cosine space."""
        import numpy as np

        return np.float32(math.cos(math.radians(float(np.float32(self.cylinder_deg_z)))))

    @property
    def slope_param(self):
        """f32(angleFilter3_f32 * (M_PI/180)) (star_shaped_search.cpp:160)."""
        import numpy as np

        return np.float32(float(np.float32(self.curb_slope_deg)) * (math.pi / 180.0))

    # ---- static/dynamic split (the no-retrace hot-swap machinery) ----
    def split(self) -> tuple["StaticConfig", "DynConfig"]:
        """(static, dynamic) halves for the jitted pipeline.

        `static` is the hashable jit cache key: method toggles and the
        structure-determining ints.  `dynamic` is a pytree of f32/i32
        scalars fed as device operands — replacing any of them between
        scans hits the jit cache (no re-trace), the functional equivalent
        of the reference's instant `paramsCallback` (main.cpp:4-34).
        Host-only fields (topic/frame names, the poly_* marker post-
        processing knobs) are in neither half: they never reach the trace.
        """
        import numpy as np

        st = StaticConfig(
            x_zero_method=bool(self.x_zero_method),
            z_zero_method=bool(self.z_zero_method),
            star_shaped_method=bool(self.star_shaped_method),
            blind_spots=bool(self.blind_spots),
            x_direction=int(self.x_direction),
            curb_points=int(self.curb_points),
            starbeam_filter=bool(self.starbeam_filter),
            probably_road_ring=int(self.probably_road_ring),
        )
        dyn = DynConfig(
            interval=np.float32(self.interval),
            curb_height=np.float32(self.curb_height),
            beam_zone=np.float32(self.beam_zone),
            min_x=np.float32(self.min_x), max_x=np.float32(self.max_x),
            min_y=np.float32(self.min_y), max_y=np.float32(self.max_y),
            min_z=np.float32(self.min_z), max_z=np.float32(self.max_z),
            kdev_param=np.float32(self.kdev_param),
            kdist_param=np.float32(self.kdist_param),
            dmin_param=np.int32(self.dmin_param),
            cos_x=self.cos_x, cos_z=self.cos_z,
            slope_param=self.slope_param,
        )
        return st, dyn


class DynConfig(NamedTuple):
    """Dynamic (no-retrace) pipeline parameters, a pytree of scalars.

    Includes the host-precomputed derived constants (cos_x/cos_z/
    slope_param) so their float64 round-trip matches the reference's
    double intermediates bit-for-bit regardless of jit."""

    interval: Any
    curb_height: Any
    beam_zone: Any
    min_x: Any
    max_x: Any
    min_y: Any
    max_y: Any
    min_z: Any
    max_z: Any
    kdev_param: Any
    kdist_param: Any
    dmin_param: Any
    cos_x: Any
    cos_z: Any
    slope_param: Any


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Trace-static config half: the jit cache key.  Changing any of these
    re-traces (new control flow / shapes); see FilterConfig.split."""

    x_zero_method: bool
    z_zero_method: bool
    star_shaped_method: bool
    blind_spots: bool
    x_direction: int
    curb_points: int
    starbeam_filter: bool
    probably_road_ring: int

    def merge(self, dyn: DynConfig, params=None) -> "RunConfig":
        return RunConfig(self, dyn, params)


class RunConfig:
    """Config view inside a trace: static fields are Python values, dynamic
    fields may be tracers.  Duck-types FilterConfig for every field the
    device ops read (ops annotate FilterConfig; either works).

    In the port the dynamic fields are 0-d views of ``params``, the (15,)
    float32 parameter buffer on the scan's device (``device_config``), or
    host scalars when ``params`` is None."""

    __slots__ = ("_st", "_dyn", "params")

    def __init__(self, st: StaticConfig, dyn: DynConfig, params=None):
        object.__setattr__(self, "_st", st)
        object.__setattr__(self, "_dyn", dyn)
        object.__setattr__(self, "params", params)

    def __getattr__(self, name: str):
        st = object.__getattribute__(self, "_st")
        if hasattr(st, name):
            return getattr(st, name)
        return getattr(object.__getattribute__(self, "_dyn"), name)

    @property
    def static(self) -> StaticConfig:
        return object.__getattribute__(self, "_st")


# ---- the dynamic half on a device ----
# One float32 slot per DynConfig field, in its order; dmin_param's slot
# holds the bits of an int32.  The kernels read their parameters from this
# buffer (csrc/*.cu), so a compiled entry point's CUDA graph sees a new
# value after one write into it, with no re-capture.
DYN_INDEX = {name: i for i, name in enumerate(DynConfig._fields)}
DYN_INT = "dmin_param"
PARAM_CACHE_SIZE = 256  # parameter buffers kept per process (LRU)

_param_cache: dict = {}  # (device, packed bytes) -> (host copy, buffer)
_config_cache: dict = {}  # (config, device) -> RunConfig


def dynamic_of(cfg) -> DynConfig:
    """The dynamic half of a FilterConfig, or of a RunConfig on host
    scalars."""
    if isinstance(cfg, RunConfig):
        return DynConfig(*(getattr(cfg, f) for f in DynConfig._fields))
    return cfg.split()[1]


def pack_dyn(dyn: DynConfig):
    """The (15,) float32 host array of a DynConfig: each float field
    rounded to float32 (the host precomputes cos_x, cos_z and slope_param
    in float64, as split does), dmin_param's int32 bits in its slot."""
    import numpy as np

    out = np.zeros(len(DynConfig._fields), np.float32)
    for name, v in zip(DynConfig._fields, dyn):
        if name == DYN_INT:
            out[DYN_INDEX[name]:DYN_INDEX[name] + 1].view(np.int32)[0] = (
                np.int32(v))
        else:
            out[DYN_INDEX[name]] = np.float32(v)
    return out


def _device(device):
    """torch.device(device), a CUDA device with its index."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _lru_put(cache: dict, key, value) -> None:
    cache[key] = value
    while len(cache) > PARAM_CACHE_SIZE:
        cache.pop(next(iter(cache)))


def param_buffer(dyn: DynConfig, device):
    """The (15,) float32 parameter buffer of ``dyn`` on ``device``, made
    once per value and device and cached (keyed by the packed bytes).  On
    the card it is copied from pinned host memory on the device's current
    stream, without blocking the host; use it from that stream.  Never
    written: the compiled entry points copy it into their own buffer."""
    import torch

    dev = _device(device)
    host = pack_dyn(dyn)
    key = (dev, host.tobytes())
    hit = _param_cache.pop(key, None)
    if hit is None:
        src = torch.from_numpy(host)
        if dev.type == "cuda":
            src = src.pin_memory()
            with torch.cuda.device(dev):
                hit = (src, src.to(dev, non_blocking=True))
        else:
            hit = (src, src.clone())
    _lru_put(_param_cache, key, hit)
    return hit[1]


def dyn_views(params) -> DynConfig:
    """A DynConfig of 0-d views of a parameter buffer: float32 tensors, and
    dmin_param an int32 one."""
    import torch

    ints = params.view(torch.int32)
    return DynConfig(*(ints[i] if name == DYN_INT else params[i]
                       for name, i in DYN_INDEX.items()))


def bind_params(st: StaticConfig, params) -> RunConfig:
    """The RunConfig whose dynamic fields are views of ``params``."""
    return RunConfig(st, dyn_views(params), params)


_split_cache: dict = {}  # config -> (StaticConfig, DynConfig)


def split_cached(cfg: FilterConfig):
    """cfg.split(), kept per configuration (LRU)."""
    try:
        hit = _split_cache.pop(cfg, None)
    except TypeError:  # an unhashable field value
        return cfg.split()
    if hit is None:
        hit = cfg.split()
    _lru_put(_split_cache, cfg, hit)
    return hit


def device_config(cfg, device) -> RunConfig:
    """``cfg`` (a FilterConfig, or a RunConfig) with its dynamic fields read
    from the cached parameter buffer of its values on ``device``: what the
    entry points hand the stages.  A RunConfig already bound to a buffer
    on ``device`` is returned as it is; no host-to-device copy is made for
    a configuration seen before on that device."""
    dev = _device(device)
    if isinstance(cfg, RunConfig):
        if cfg.params is not None and cfg.params.device == dev:
            return cfg
        return bind_params(cfg.static, param_buffer(dynamic_of(cfg), dev))
    try:
        key = (cfg, dev)
        hit = _config_cache.pop(key, None)
    except TypeError:  # an unhashable field value
        key, hit = None, None
    if hit is None:
        st, dyn = split_cached(cfg)
        hit = bind_params(st, param_buffer(dyn, dev))
    if key is not None:
        _lru_put(_config_cache, key, hit)
    return hit


@dataclasses.dataclass(frozen=True)
class PipelineDims:
    """Static tensor dimensions of the padded device layout.

    The reference allocates a fresh ``channels x piece`` Point3D matrix per
    scan (~300 MB at 100k pts, lidar_segmentation.cpp:207).  We instead use a
    fixed padded layout with validity masks; overflow is counted and dropped.
    """

    max_points: int = 131072  # point capacity per scan (N); inputs are padded
    rings: int = 64  # ring/channel cap (reference hardcodes 64,
    # lidar_segmentation.cpp:4; >64 is a deliberate extension for
    # high-channel sensors — discovery, binning, flood fill and markers all
    # scale with this)
    ring_capacity: int = 4096  # slots per ring (P)
    beam_capacity: int = 1024  # DEPRECATED: the round-2 star path keeps
    # every point per beam (no radial truncation), so this no longer
    # affects results; retained for preset/API compatibility

    def __post_init__(self) -> None:
        if (self.max_points <= 0 or self.rings <= 0
                or self.ring_capacity <= 0 or self.beam_capacity <= 0):
            raise ValueError("dims must be positive")
        if self.ring_capacity % 64 != 0:
            # Kept from the JAX package, whose TPU kernels tile the slot
            # axis in 64-multiples, so that one PipelineDims is valid for
            # both packages.
            raise ValueError(
                f"ring_capacity={self.ring_capacity} must be a multiple of 64")

    @classmethod
    def for_sensor(cls, kind: str) -> "PipelineDims":
        """Preset dims for common sensors."""
        presets = {
            "vlp16": cls(max_points=32768, rings=64, ring_capacity=2048, beam_capacity=256),
            "os1-64": cls(max_points=131072, rings=64, ring_capacity=4096, beam_capacity=1024),
            "os1-128": cls(max_points=262144, rings=128, ring_capacity=8192, beam_capacity=2048),
            "tiny": cls(max_points=1024, rings=64, ring_capacity=256, beam_capacity=64),
        }
        try:
            return presets[kind]
        except KeyError:
            raise ValueError(f"unknown sensor preset {kind!r}; have {sorted(presets)}")
