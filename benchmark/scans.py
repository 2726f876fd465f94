"""Traffic: the benchmark's scans, made from the seed.

A frozen NumPy copy of the port's drive emulator
(urban_road_filter_torch/io/synthetic.py: SceneSpec, SensorModel, SENSORS,
make_sensor_scan, make_drive), kept here so that the yardstick does not move
when the program changes; it imports nothing of the program.  The same seed
gives the same bytes as the original (benchmark/tests pins that).

``make_pool`` is the one general generator: a traffic file's parameters
(sensor, firings, pool size, drive speed and rate) select the scans, and
the seed selects the drive.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.reference import azimuth_2d


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Piecewise-flat world: road plane at z = -sensor_height, optional
    sidewalk steps along +/-y, optional walls, optional ramp along x."""

    sensor_height: float = 1.7
    curb_right_y: float | None = 3.5    # sidewalk for y >= curb_right_y
    curb_left_y: float | None = -3.5    # sidewalk for y <= curb_left_y
    curb_height: float = 0.18
    ramp_slope: float = 0.0             # dz/dx of the road surface
    wall_x: float | None = None         # vertical wall at x = wall_x
    curb_gap: tuple[float, float] | None = None  # x-range with no curbs (gap)
    obstacles: tuple[tuple[float, float, float], ...] = ()  # (x, y, radius) posts
    # Clutter for the realistic-drive corpus (VERDICT r3 item 3):
    # vehicles: axis-aligned boxes (cx, cy, half_x, half_y, height above
    # local ground) — parked/oncoming cars, solid returns.
    vehicles: tuple[tuple[float, float, float, float, float], ...] = ()
    # vegetation: porous spheres (cx, cy, cz, radius) — hedges/canopies;
    # rays hitting one return from a rough surface (extra range noise) and
    # are often lost entirely (partial transmission).
    vegetation: tuple[tuple[float, float, float, float], ...] = ()


def _ground_z(spec: SceneSpec, xx: np.ndarray, yy: np.ndarray) -> np.ndarray:
    """Surface height z(x, y) of the piecewise world."""
    z = -spec.sensor_height + spec.ramp_slope * np.maximum(xx, 0.0)
    on_side = np.zeros_like(xx, dtype=bool)
    if spec.curb_right_y is not None:
        on_side |= yy >= spec.curb_right_y
    if spec.curb_left_y is not None:
        on_side |= yy <= spec.curb_left_y
    if spec.curb_gap is not None:
        g0, g1 = spec.curb_gap
        on_side &= ~((xx >= g0) & (xx <= g1))
    return z + np.where(on_side, spec.curb_height, 0.0)


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Spinning-LiDAR emulation parameters (datasheet-plausible; the real
    per-unit calibration files are not available in this environment)."""

    name: str
    elevations_deg: tuple[float, ...]      # per beam, FIRING order
    azimuth_offsets_deg: tuple[float, ...]  # per beam (Ouster column offsets)
    firings_per_rev: int
    range_sigma: float                     # 1-sigma range noise (m)
    elev_jitter_deg: float                 # per-point pointing jitter (deg)
    max_range: float
    dropout_base: float                    # uniform per-return loss floor
    dropout_range_k: float                 # + k * (t / max_range)^2
    weak_beam_frac: float                  # beams with degraded sensitivity


def _vlp16_elevations() -> tuple[float, ...]:
    """VLP-16 channel elevations in FIRING order: the datasheet interleaves
    the -15..+15 deg fan as (-15, 1, -13, 3, ..., -1, 15).  The +deg beams
    exercise the reference's z >= 0 vertical-angle branch (asin + 90,
    lidar_segmentation.cpp:151-166)."""
    return tuple(float(-15 + i) if i % 2 == 0 else float(i)
                 for i in range(16))


def _gradient_elevations(n: int, fov_deg: float,
                         shape: float = 0.6) -> tuple[float, ...]:
    """Ouster-style gradient beam table: denser near the horizon, sparser at
    the FOV edges (u + shape*u^3 warp of a uniform fan)."""
    u = np.linspace(-1.0, 1.0, n)
    raw = u + shape * u ** 3
    return tuple((0.5 * fov_deg * raw / raw[-1]).tolist())


def _os1_azimuth_offsets(n: int) -> tuple[float, ...]:
    """OS1 beams sit in four columns with repeating azimuth offsets."""
    phases = (3.164, 1.055, -1.055, -3.164)
    return tuple(phases[i % 4] for i in range(n))


SENSORS: dict[str, SensorModel] = {
    "vlp16": SensorModel(
        name="vlp16", elevations_deg=_vlp16_elevations(),
        azimuth_offsets_deg=(0.0,) * 16, firings_per_rev=1800,
        range_sigma=0.012, elev_jitter_deg=0.015, max_range=100.0,
        dropout_base=0.01, dropout_range_k=0.03, weak_beam_frac=0.10),
    "os1_64": SensorModel(
        name="os1_64", elevations_deg=_gradient_elevations(64, 45.0),
        azimuth_offsets_deg=_os1_azimuth_offsets(64), firings_per_rev=1024,
        range_sigma=0.025, elev_jitter_deg=0.02, max_range=120.0,
        dropout_base=0.015, dropout_range_k=0.05, weak_beam_frac=0.12),
    "os1_128": SensorModel(
        name="os1_128", elevations_deg=_gradient_elevations(128, 45.0),
        azimuth_offsets_deg=_os1_azimuth_offsets(128), firings_per_rev=1024,
        range_sigma=0.025, elev_jitter_deg=0.02, max_range=120.0,
        dropout_base=0.015, dropout_range_k=0.05, weak_beam_frac=0.12),
}


def _march_world(spec: SceneSpec, dx: np.ndarray, dy: np.ndarray,
                 dz: np.ndarray, max_range: float):
    """Closest hit per unit ray from the origin.  Returns (t, surface) with
    t = NaN for no return and surface codes 0 ground / 1 wall / 2 post /
    3 vehicle / 4 vegetation."""
    # Ground (piecewise-flat) via bisection, downward rays only.
    lo = np.full(dx.shape, 0.05)
    hi = np.full(dx.shape, max_range)
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        above = mid * dz > _ground_z(spec, mid * dx, mid * dy)
        lo = np.where(above, mid, lo)
        hi = np.where(above, hi, mid)
    t = np.where(dz < 0, 0.5 * (lo + hi), np.nan)
    t = np.where(t > max_range * 0.999, np.nan, t)
    surface = np.zeros(dx.shape, np.int8)

    def closer(tq, code):
        nonlocal t, surface
        win = tq < np.nan_to_num(t, nan=np.inf)
        t = np.where(win, tq, t)
        surface = np.where(win, np.int8(code), surface)

    if spec.wall_x is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = spec.wall_x / dx
        closer(np.where((dx > 1e-9) & (tw > 0.05), tw, np.inf), 1)

    for ox, oy, orad in spec.obstacles:  # vertical posts (2-D circles)
        b = dx * ox + dy * oy
        c = ox * ox + oy * oy - orad * orad
        disc = b * b - (dx * dx + dy * dy) * c
        with np.errstate(invalid="ignore", divide="ignore"):
            tq = (b - np.sqrt(np.maximum(disc, 0.0))) / (dx * dx + dy * dy)
        closer(np.where((disc > 0) & (tq > 0.05), tq, np.inf), 2)

    for cx, cy, hx, hy, h in spec.vehicles:  # solid boxes on the ground
        zc = float(_ground_z(spec, np.asarray(cx), np.asarray(cy)))
        tnear = np.full(dx.shape, -np.inf)
        tfar = np.full(dx.shape, np.inf)
        for d, lo_w, hi_w in ((dx, cx - hx, cx + hx),
                              (dy, cy - hy, cy + hy),
                              (dz, zc, zc + h)):
            dd = np.where(np.abs(d) < 1e-12, 1e-12, d)
            t1, t2 = lo_w / dd, hi_w / dd
            tnear = np.maximum(tnear, np.minimum(t1, t2))
            tfar = np.minimum(tfar, np.maximum(t1, t2))
        closer(np.where((tfar >= tnear) & (tnear > 0.05), tnear, np.inf), 3)

    for cx, cy, cz, r in spec.vegetation:  # porous spheres (3-D)
        b = dx * cx + dy * cy + dz * cz
        disc = b * b - (cx * cx + cy * cy + cz * cz - r * r)
        with np.errstate(invalid="ignore"):
            tq = b - np.sqrt(np.maximum(disc, 0.0))
        closer(np.where((disc > 0) & (tq > 0.05), tq, np.inf), 4)

    # Returns beyond the sensor's range budget are lost, whatever surface
    # produced them (closest-hit candidates above are not range-clamped).
    t = np.where(t > max_range * 0.999, np.nan, t)
    return t, surface


def make_sensor_scan(
    spec: SceneSpec,
    sensor: str | SensorModel = "os1_64",
    seed: int = 0,
    firings: int | None = None,
    rate_jitter: float = 0.02,
    n_bursts: int = 2,
) -> np.ndarray:
    """Emulate one revolution of a real spinning sensor over the scene.

    Returns (N, 4) float32 [x, y, z, intensity], azimuth-major (one full
    beam column per firing), N = firings * n_beams; missing returns are
    (0, 0, 0) rows exactly like `make_scan` (the reference drops them at
    lidar_segmentation.cpp:111).
    """
    if isinstance(sensor, str):
        sensor = SENSORS[sensor]
    rng = np.random.default_rng(seed)
    A = int(firings if firings is not None else sensor.firings_per_rev)
    R = len(sensor.elevations_deg)

    # Azimuth grid with rotation-rate skew: the encoder advances at a
    # smoothly varying rate (+-rate_jitter), so azimuth density is non-
    # uniform across the revolution.
    phase = rng.uniform(0.0, 2.0 * np.pi)
    rate = 1.0 + rate_jitter * np.sin(2.0 * np.pi * np.arange(A) / A + phase)
    az = 2.0 * np.pi * np.concatenate([[0.0], np.cumsum(rate)[:-1]]) / rate.sum()
    az2d = az[:, None] + np.deg2rad(sensor.azimuth_offsets_deg)[None, :]

    # Per-point beam-pointing jitter (vibration + divergence): unlike range
    # noise (which moves points ALONG the ray, leaving the vertical angle
    # exact), this perturbs the angle ring discovery actually clusters.
    elev = (np.deg2rad(sensor.elevations_deg)[None, :]
            + np.deg2rad(sensor.elev_jitter_deg)
            * rng.standard_normal((A, R)))
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az2d), np.sin(az2d)
    dx, dy, dz = ca * ce, sa * ce, se

    t, surface = _march_world(spec, dx, dy, dz, sensor.max_range)
    t = t + rng.normal(0.0, sensor.range_sigma, t.shape)
    # Vegetation returns come off a rough, porous surface.
    t = np.where(surface == 4, t + rng.normal(0.0, 0.08, t.shape), t)

    # Structured dropout: base + range falloff + weak beams + vegetation
    # transmission + azimuth burst sectors (blooming/occlusion).
    p = sensor.dropout_base + sensor.dropout_range_k * np.square(
        np.nan_to_num(t, nan=0.0) / sensor.max_range)
    n_weak = int(np.ceil(sensor.weak_beam_frac * R))
    weak = rng.choice(R, size=n_weak, replace=False)
    p[:, weak] += 0.15
    p = np.where(surface == 4, p + 0.45, p)
    for _ in range(int(n_bursts)):
        a0 = rng.uniform(0.0, 2.0 * np.pi)
        width = np.deg2rad(rng.uniform(1.0, 4.0))
        in_burst = np.mod(az - a0, 2.0 * np.pi) < width
        p[in_burst, :] = np.maximum(p[in_burst, :], 0.8)
    miss = ~np.isfinite(t) | (rng.random(t.shape) < p)

    x = np.where(miss, 0.0, t * dx).astype(np.float32)
    y = np.where(miss, 0.0, t * dy).astype(np.float32)
    z = np.where(miss, 0.0, t * dz).astype(np.float32)
    inten = np.where(surface == 4, 0.15 + 0.1 * rng.random(t.shape),
                     np.where(surface >= 1, 0.6 + 0.3 * rng.random(t.shape),
                              0.3 + 0.2 * rng.random(t.shape))).astype(np.float32)
    return np.stack([x, y, z, inten], axis=-1).reshape(-1, 4)


def make_drive(
    n_scans: int,
    sensor: str | SensorModel = "os1_64",
    seed: int = 0,
    speed_mps: float = 8.0,
    rate_hz: float = 10.0,
    firings: int | None = None,
):
    """Yield a recorded-style drive: make_sensor_scan of each of
    drive_specs' scenes, one after the other."""
    for spec, scan_seed in drive_specs(n_scans, seed, speed_mps, rate_hz):
        yield make_sensor_scan(spec, sensor=sensor, seed=scan_seed,
                               firings=firings)


def drive_specs(n_scans: int, seed: int = 0, speed_mps: float = 8.0,
                rate_hz: float = 10.0):
    """Yield (scene, scan seed) of each scan of a recorded-style drive: the
    vehicle advances along a street whose curb lines meander, with periodic driveway gaps, parked vehicles
    near the curbs, hedges/canopies beyond them, and one oncoming car.

    The world is procedurally generated from `seed` in STREET coordinates
    (s = distance driven); each scan is the world transformed into the
    vehicle frame at s = scan_index * speed / rate, emulating the
    reference's campus-rosbag replay (reference README.md:36-46) without
    recorded data.
    """
    rng = np.random.default_rng(seed ^ 0x5EED)
    length = n_scans * speed_mps / rate_hz + 150.0
    # Parked cars: every ~25 m on one side or the other, just inside a curb.
    park_s = np.arange(15.0, length, 25.0) + rng.uniform(-5.0, 5.0,
                                                         len(np.arange(15.0, length, 25.0)))
    park_side = rng.integers(0, 2, len(park_s)) * 2 - 1
    # Vegetation: hedge blobs beyond each curb every ~12 m.
    veg_s = np.arange(5.0, length, 12.0)
    veg_side = rng.integers(0, 2, len(veg_s)) * 2 - 1
    veg_r = rng.uniform(0.8, 1.8, len(veg_s))
    # Driveway gaps every ~60 m, 4-7 m wide.
    gap_s = np.arange(40.0, length, 60.0)
    gap_w = rng.uniform(4.0, 7.0, len(gap_s))

    for i in range(n_scans):
        s = i * speed_mps / rate_hz
        cr = 3.3 + 0.6 * np.sin(s / 37.0)          # right curb meander
        cl = -3.4 - 0.5 * np.sin(s / 29.0 + 1.0)   # left curb meander
        # Nearest driveway gap ahead/behind, in vehicle coordinates.
        gap = None
        j = int(np.argmin(np.abs(gap_s - s))) if len(gap_s) else -1
        if j >= 0 and abs(gap_s[j] - s) < 45.0:
            gap = (float(gap_s[j] - s), float(gap_s[j] - s + gap_w[j]))
        vehicles = []
        for ps, side in zip(park_s, park_side):
            if -10.0 < ps - s < 60.0:
                vehicles.append((float(ps - s), float(side * (cr - 0.9)),
                                 2.2, 0.85, 1.5))
        # One oncoming car in the opposing lane, closing at 2x speed.
        on_s = length * 0.6 - s * 1.0  # world pos falls as we drive
        if -10.0 < on_s - s < 70.0:
            vehicles.append((float(on_s - s), -1.8, 2.2, 0.85, 1.5))
        vegetation = []
        for vs, side, r in zip(veg_s, veg_side, veg_r):
            if -10.0 < vs - s < 60.0:
                yv = side * (abs(cr if side > 0 else cl) + 1.5 + r)
                vegetation.append((float(vs - s), float(yv),
                                   float(-1.7 + 0.6 * r), float(r)))
        spec = SceneSpec(curb_right_y=float(cr), curb_left_y=float(cl),
                         curb_height=0.16 + 0.04 * float(np.sin(s / 53.0)),
                         curb_gap=gap, vehicles=tuple(vehicles),
                         vegetation=tuple(vegetation))
        yield spec, seed + 7919 * i




def azimuth_sorted(scan: np.ndarray) -> np.ndarray:
    """The (M, >=3) scan's rows in order of the 2-D azimuth, NaN azimuths
    last, ties in input order: the order a spinning sensor emits, which the
    SP path's ring order assumes (a copy of the port's
    parallel.azimuth_parallel.azimuth_sorted)."""
    _, aa = azimuth_2d(np.asarray(scan[:, 0], np.float32),
                       np.asarray(scan[:, 1], np.float32))
    return scan[np.argsort(np.where(np.isnan(aa), 1e30, aa), kind="stable")]


def make_pool(traffic: dict, sensor: str, firings: int, seed: int,
              threads: int = 4) -> list:
    """The cell's distinct scans: ``traffic["pool"]`` consecutive scans of
    the drive that ``seed`` selects (``traffic["speed_mps"]`` and
    ``["rate_hz"]`` set how far apart they are), each the (M, 4) float32
    rows that a subscriber receives, azimuth-sorted.  The scans are made
    on ``threads`` threads (NumPy releases the interpreter lock in its
    array loops); the bytes do not depend on it."""
    seed = int(seed) % (1 << 63)
    specs = list(drive_specs(int(traffic["pool"]), seed,
                             float(traffic["speed_mps"]),
                             float(traffic["rate_hz"])))

    def one(item):
        spec, scan_seed = item
        rows = make_sensor_scan(spec, sensor=sensor, seed=scan_seed,
                                firings=firings)
        return np.ascontiguousarray(azimuth_sorted(rows))

    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(one, specs))
