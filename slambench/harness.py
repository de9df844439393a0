"""One run of one cell of the benchmark of ``weiner_slamit_v2_torch``.

Set-up (counted in ``setup_s``): imports, the cell's configuration, traffic
and limits read by name from ``BENCHMARK.json``'s entries, every frame
rendered from the seed, the System built (which captures its pose LM's tail
graph and, at its first launch, loads the kernels built in the checkout),
and the warm-up: frames tracked from frame 0 until the map holds the
traffic's number of keyframes (and at least its number of frames). Then
``gc.collect()`` and ``gc.freeze()``, and the card synchronized.

The window: one camera in a closed loop, the next frame (a monocular
image, a rectified stereo pair or an image with its depth, as the
configuration's ``sensor`` says) handed to ``System.track_monocular``,
``track_stereo`` or ``track_rgbd`` when the last call returned and the card
was synchronized, for ``--seconds`` of wall time. ``frame_ms`` is
the window's wall time over the frames completed in it, every frame
counted. The 92nd percentile of the frames' latencies is printed beside it
on an earlier line (PERF.md: it is not a metric, its runs spread too far).

``--trace 1`` adds the spans of ``probes.py`` over the window, then tracks
on past it with ``torch.profiler`` tracing some frames (the traffic's
``trace`` entry says which; the profiler slows the host, so no span is
timed there) with the program's own span recorder installed
(``spans.recording``); its result line carries the cell's per-layer
metrics, each read by its own reader ``metrics/<name>.py`` from a
``Context``: the benchmark's spans, the trace reduced with the program's
spans, the window's counts, and the session (``system``) and the probes
(``rec``) themselves, so that a reader file alone can read a program
counter.

After the window the program's state is freed and ``check.judge`` decides
``correct``. Earlier lines (standard error) give the run's session: the
frames of keyframes, adopted passes, LOST frames and relocalizations, the
OK frames and the ATE; the last lines there, and the result's last key,
give each number compared with its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# torch's intra-op threads: the host path launches small kernels from one
# thread; measured on the card's machine (PERF.md)
TORCH_THREADS = 1
FORBIDDEN = ("jax", "jaxlib", "flax", "weiner_slamit_v2_tpu")
WARMUP_FRAMES_MAX = 600
# the tail: with a keyframe (and its fused mapping pass) every 8-10 frames,
# the 92nd percentile lies among the keyframe frames at every window length
# from 100 frames up, where the 90th can fall between them and the others
TAIL_PERCENTILE = 92


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# the compared numbers a sensor's cell must have limits for (check.py)
SENSOR_NUMBERS = {"monocular": (), "stereo": ("stereo_match_diff", "stereo_ur_err"),
                  "rgbd": ("rgbd_depth_diff",)}


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entries and files, found by the names in BENCHMARK.json
    (the traffic, limits and readers under ``root``'s copy of this
    directory)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return dict(
        bench=bench, workload=wl,
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads((root / HERE.name / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=json.loads((root / HERE.name / "limits" / f"{name}.json").read_text()),
        metrics_dir=root / HERE.name / "metrics",
        end_to_end=[m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        per_layer=per_layer,
    )


def slam_config(c: dict, seed: int, scale: float = 1.0, capacity: dict | None = None):
    """The program's SlamConfig as the configuration file states it (the
    tests shrink the image and the pools)."""
    from weiner_slamit_v2_torch.config import (CameraConfig, MapCapacityConfig, OrbConfig,
                                               SlamConfig, TrackingConfig)

    cam = dict(c["camera"])
    if scale != 1.0:
        for k in ("fx", "fy", "cx", "cy", "baseline_times_fx"):
            cam[k] *= scale
        cam["width"], cam["height"] = round(cam["width"] * scale), round(cam["height"] * scale)
    orb = dict(c["orb"])
    if capacity is not None:
        orb["n_features"] = capacity.get("n_features", orb["n_features"])
    cap = {k: v for k, v in {**c["capacity"], **(capacity or {})}.items() if k != "n_features"}
    return SlamConfig(camera=CameraConfig(**cam), orb=OrbConfig(**orb),
                      tracking=TrackingConfig(**c["tracking"]), capacity=MapCapacityConfig(**cap),
                      sensor=c["sensor"], seed=seed)


def frame_times(latencies_s: list, window_s: float) -> tuple[float, float]:
    """(frame_ms, frame_ms_p92): the window's wall time over the frames
    completed in it, and the 92nd percentile of every frame's latency."""
    if not latencies_s:
        return math.nan, math.nan
    return (1e3 * window_s / len(latencies_s),
            float(np.percentile(1e3 * np.asarray(latencies_s), TAIL_PERCENTILE)))


def host_probe_ms() -> float:
    """ms of a fixed piece of Python work: the host's pace, printed beside
    the window's numbers (the program is bound by the host's launches)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t0)


def cpu_steal() -> int:
    """Jiffies the hypervisor gave other guests (/proc/stat), 0 where unread."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8])
    except (OSError, IndexError, ValueError):
        return 0


def card_clocks() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class Context:
    """What the per-layer readers read: ``frames``, ``passes``, ``lost`` of
    the timed window; ``spans`` (the benchmark's, seconds by name);
    ``trace`` (``trace.reduce``, the program's spans' account with it);
    ``traced_frames``, ``traced_fuses``, ``level_shapes``,
    ``deferred_adoptions``; ``system`` (the session, still live) and ``rec``
    (the probes' ``Recorder``)."""

    def __init__(self, **kw):
        self.trace = None
        self.traced_frames = 0
        self.traced_fuses = []
        self.system = self.rec = None
        self.__dict__.update(kw)

    def span_mean_ms(self, name: str):
        s = self.spans.get(name)
        return 1e3 * sum(s) / len(s) if s else None


def read_metric(name: str, ctx: Context, metrics_dir: Path = HERE / "metrics"):
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}",
                                                  metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _feeder(system, tr, sensor: str):
    """Frame i handed to the session's entry for the sensor."""
    if sensor == "stereo":
        return lambda i: system.track_stereo(tr.images[i], tr.right_images[i],
                                             float(tr.timestamps[i]))
    if sensor == "rgbd":
        return lambda i: system.track_rgbd(tr.images[i], tr.depths[i], float(tr.timestamps[i]))
    if sensor != "monocular":
        raise ValueError(f"no feeder for the sensor {sensor!r}")
    return lambda i: system.track_monocular(tr.images[i], float(tr.timestamps[i]))


def _trace_plan(traffic: dict, first: int) -> tuple[int, int, str | None]:
    """(first traced frame, least number of traced frames, the event the
    traced frames must hold: 'pass' or 'reloc'), for traced frames that
    follow the timed window from frame ``first`` on: with ``before_cover``,
    they start that many frames before the next covered frame."""
    t = traffic.get("trace", {})
    start = first
    kid = traffic.get("kidnap")
    if kid and t.get("before_cover") is not None:
        rel = first - kid["start"]
        k = max(0, -(-(rel - kid["offset"]) // kid["period"]))
        start = max(first, kid["start"] + k * kid["period"] + kid["offset"] - t["before_cover"])
    return start, t.get("frames", 10), t.get("until")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, t_start: float | None = None, root: Path = ROOT,
             scale: float = 1.0, n_frames: int | None = None, warmup_keyframes: int | None = None,
             capacity: dict | None = None, traffic_overrides: dict | None = None,
             before_window=None) -> dict:
    """One run; returns the result line's object (and logs the rest).
    ``scale``, ``n_frames``, ``warmup_keyframes``, ``capacity`` and
    ``traffic_overrides`` (top-level keys of the traffic file) shrink the run
    for the CPU tests; ``before_window(system)`` runs just before the window
    opens (the tests break the timed path there)."""
    import torch

    from weiner_slamit_v2_torch.tracking.system import System

    from . import check, evaluation, probes, spans as spans_mod, trace as trace_mod, world
    from .reference import stages
    from .reference.port.config import OrbConfig as RefOrbConfig
    from .reference.port.ops.pyramid import level_shapes

    t_start = time.perf_counter() if t_start is None else t_start
    torch.set_num_threads(TORCH_THREADS)
    cell = load_cell(workload, root)
    c, traffic = cell["config"], {**cell["traffic"], **(traffic_overrides or {})}
    sensor = c["sensor"]
    missing = [k for k in SENSOR_NUMBERS.get(sensor, ()) if k not in cell["limits"]]
    if sensor not in SENSOR_NUMBERS or missing:
        raise SystemExit(f"{workload}: a {sensor} cell's limits must name {missing or sensor}")
    cfg_seed = seed % 2**31
    cfg = slam_config(c, cfg_seed, scale, capacity)
    cam = {k: getattr(cfg.camera, k) for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                                               "k3", "width", "height", "fps",
                                               "baseline_times_fx")}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = card_line() if on_card else "cpu"
    marks = [("imports", time.perf_counter())]
    tr = world.build_traffic(traffic, {**c["camera"], **cam}, sensor, seed, dev, n_frames=n_frames)
    sync()
    marks.append(("render", time.perf_counter()))
    system = System(cfg, device=dev, enable_mapping=c["enable_mapping"],
                    enable_loop_closing=c["enable_loop_closing"])
    marks.append(("system", time.perf_counter()))
    rec = probes.Recorder(system, spans=trace, sync=sync)
    feed = _feeder(system, tr, sensor)
    n = len(tr.images)
    want_kf = warmup_keyframes or tr.warmup_keyframes
    i = 0
    while True:
        feed(i)
        i += 1
        n_kf = system.tracker.n_kf_host       # keyframes created (the JAX bench's rule)
        if n_kf >= want_kf and i >= tr.min_warmup_frames:
            break
        if i >= min(WARMUP_FRAMES_MAX, n - 1):
            raise RuntimeError(f"warm-up: {n_kf} keyframes after {i} frames, want {want_kf}")
    warm_frames = i
    gc.collect()
    gc.freeze()
    sync()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", time.perf_counter()))
    parts = ", ".join(f"{k} {b - a:.2f} s" for (_, a), (k, b) in zip([("", t_start)] + marks, marks))
    log(f"{workload} seed {seed}: {card}; torch {torch.__version__}, {TORCH_THREADS} torch "
        f"thread(s); {n} frames rendered ({tr.images.shape[1]}x{tr.images.shape[2]}, {sensor}; "
        f"textures {tr.texture_bytes} B); "
        f"warm-up {warm_frames} frames to {n_kf} keyframes; setup_s {setup_s:.4f} ({parts})")

    # --- the window ------------------------------------------------------------------
    if before_window is not None:
        before_window(system)
    lat, outs, passes_at, errors = [], [], [], []

    def frame(i: int) -> float:
        """Hand frame i over, wait for the card; its latency in seconds."""
        prev_state, before = system.tracker.state, system.mapping_passes
        t0 = time.perf_counter()
        try:
            with rec.span(probes.SPAN_TRACK):
                out = feed(i)
            sync()
        except Exception as e:   # a defect: counted in failed, the run goes on
            out = None
            errors.append((i, f"{type(e).__name__}: {e}"))
        dt = time.perf_counter() - t0
        outs.append((i, prev_state, out))
        if system.mapping_passes > before:
            passes_at.append(i)
        return dt

    path_end = False
    # a traced run's window leaves the path's last frames to the traced ones
    # (at most four times the traffic's least number of them)
    last = n - 4 * _trace_plan(traffic, i)[1] if trace else n
    probe0, steal0 = host_probe_ms(), cpu_steal()
    clocks0 = card_clocks() if on_card else "cpu"
    deferred0 = getattr(system, "adoptions_deferred", None)
    rec.on = True
    w0 = time.perf_counter()
    while True:
        if i >= last:
            path_end = True
            break
        lat.append(frame(i))
        i += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    deferred = None if deferred0 is None else system.adoptions_deferred - deferred0
    steal1, probe1 = cpu_steal(), host_probe_ms()
    quarters = [round(1e3 * float(np.mean(q)), 2) for q in np.array_split(np.asarray(lat), 4)
                if len(q)]
    log(f"pace: host probe {probe0:.2f} / {probe1:.2f} ms before / after the window, steal "
        f"{steal1 - steal0} jiffies in it, card {clocks0} / "
        f"{card_clocks() if on_card else 'cpu'}; mean ms a frame by quarter of the window {quarters}")
    first, frames = warm_frames, i - warm_frames
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # --- the traced frames (--trace 1): after the timed window, on the same session
    traced = [None, None]
    if trace:
        rec.span_on = False
        start, min_traced, until = _trace_plan(traffic, i)
        while i < min(start, n):
            frame(i)
            i += 1
        acts = [torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts + [torch.profiler.ProfilerActivity.CUDA] * on_card)
        recording = spans_mod.recording()
        program_rec = recording.__enter__()
        prof.start()
        span = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
        span.__enter__()
        traced[0] = i
        while i < n:
            frame(i)
            i += 1
            k = i - traced[0]
            held = (until is None
                    or (until == "pass" and bool(rec.fuses) and rec.fuses[-1][0] >= traced[0])
                    or (until == "reloc" and any(ps == "LOST" and o is not None and o.state == "OK"
                                                 for f, ps, o in outs if f >= traced[0])))
            if (k >= min_traced and held) or k >= 4 * min_traced:
                break
        span.__exit__(None, None, None)
        sync()
        prof.stop()
        recording.__exit__(None, None, None)
        traced[1] = i - 1
    rec.on = False

    # --- the session's own readings (earlier lines) ----------------------------------
    t = system.tracker
    states = [(fi, None if o is None else o.state) for fi, _, o in outs]
    lost = [fi for fi, s in states if s == "LOST"]
    kfs = [fi for fi, _, o in outs if o is not None and o.created_kf]
    relocs = [fi for fi, ps, o in outs if o is not None and ps == "LOST" and o.state == "OK"]
    bad_pose = []
    for fi, _, o in outs:
        if o is None or o.state not in ("OK", "LOST"):
            bad_pose.append(fi)
        elif o.state == "OK" and (o.Tcw is None or tuple(o.Tcw.shape) != (4, 4)
                                  or not bool(torch.isfinite(o.Tcw).all())):
            bad_pose.append(fi)
    ok = [fi for fi, s in states if s == "OK"]
    n_judged = len(outs)     # the window's frames and, traced, the frames after it
    _, Twc = t.trajectory_Twc()
    # one trajectory entry per frame since initialization: frame fi is entry
    # fi - (i - len(Twc)); the ATE is over the window's OK frames
    rows = [fi - (i - len(Twc)) for fi in ok if fi - (i - len(Twc)) >= 0]
    ate = float("nan")
    if len(rows) >= 3:
        ate = evaluation.ate_rmse(Twc[rows], tr.gt_Twc[[r + i - len(Twc) for r in rows]],
                                  align_scale=sensor == "monocular")
    log(f"window: {frames} frames (frames {first}-{first + frames - 1}) in {window_s:.4f} s"
        + (", the path ended before the window's time: the window ends there" if path_end else ""))
    log(f"keyframes created at frames {kfs}")
    log(f"mapping passes adopted at frames {passes_at}")
    log(f"LOST frames {lost}; relocalized at frames {relocs}")
    log(f"OK frames {len(ok)} of {n_judged}; covered frames {int(tr.blank[first:i].sum())}; ATE "
        f"{ate:.5f} m over the OK frames "
        f"({'scale-aligned' if sensor == 'monocular' else 'metric'}); keyframes valid "
        f"{int(t.m.kf_valid.sum())}, created {t.n_kf_host}; map-point slots allocated "
        f"{int(t.m.n_mp)} of {t.m.max_mp}; errors {errors[:3]}")

    # --- per-layer readings (traced run) ---------------------------------------------
    orb_ref = RefOrbConfig(**{k: getattr(cfg.orb, k) for k in ("n_features", "scale_factor",
                                                               "n_levels", "fast_threshold",
                                                               "fast_min_threshold", "cell_size",
                                                               "init_features_mult")})
    per_layer, breakdown, trace_red = {}, None, None
    if trace:
        t_red = time.perf_counter()
        trace_red = trace_mod.reduce(prof)
        del prof
        log(spans_mod.line(trace_red, program_rec.summary() if program_rec is not None else None)
            + f" (trace reduced in {time.perf_counter() - t_red:.2f} s)")
        end = first + frames     # the timed window's frames are first .. end - 1
        ctx = Context(
            frames=frames, passes=sum(1 for f in passes_at if f < end),
            lost=sum(1 for f in lost if f < end),
            spans=rec.span_s, trace=trace_red, traced_frames=traced[1] - traced[0] + 1,
            traced_fuses=[(a, th) for f, a, th, _ in rec.fuses if traced[0] <= f <= traced[1]],
            level_shapes=level_shapes(tr.images.shape[1], tr.images.shape[2], orb_ref.n_levels,
                                      orb_ref.scale_factor),
            deferred_adoptions=deferred, system=system, rec=rec)
        for m in cell["per_layer"]:
            v = read_metric(m["name"], ctx, cell["metrics_dir"])
            if v is not None:
                per_layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": [[k, v] for k, v in trace_red["device_ops"]],
                     "idle_gaps": [[k, v] for k, v in trace_red["idle_gaps"]]}
        del ctx
        log(f"traced frames {traced[0]}-{traced[1]}: window {trace_red['window_s']:.4f} s, device "
            f"busy {trace_red['busy_s']:.4f} s, launches {trace_red['launches']}, synchronizing "
            f"calls {trace_red['syncs']}")

    # --- free the program's state, then judge --------------------------------------
    rec.close()
    rec.sys = rec.t = None
    del system, t, outs
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    front = stages.FrontEnd(orb_ref, {**cam, "width": tr.images.shape[2],
                                      "height": tr.images.shape[1]})
    t_check = time.perf_counter()
    numbers, rejected, check_secs = check.judge(rec, tr, front, cell["limits"], cfg_seed,
                                                control=control, device=dev)
    check_s = time.perf_counter() - t_check
    failed_frames = rejected | {fi for fi, _ in errors} | set(bad_pose)
    within = all(v <= lim for v, lim, _ in numbers.values())
    correct = within and not failed_frames

    frame_ms, frame_ms_p92 = frame_times(lat, window_s)
    metrics = {}
    e2e = {"frame_ms": frame_ms, "frame_ms_p92": frame_ms_p92, "setup_s": setup_s}
    if not trace:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        metrics = per_layer
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace and trace_red is not None:
        dev_info["busy_s"] = trace_red["busy_s"]
        dev_info["window_s"] = trace_red["window_s"]
    log(f"frame_ms {e2e['frame_ms']:.4f}, frame_ms_p92 {e2e['frame_ms_p92']:.4f} over {len(lat)} "
        f"frames; memory_peak_bytes {peak}; reference check {check_s:.2f} s {check_secs}"
        + ("; control: the reference in bfloat16 in the program's place" if control else ""))
    log(f"failed frames: {sorted(failed_frames)[:20]} ({len(failed_frames)})")
    for name, (v, lim, calls) in numbers.items():
        log(f"{name}: {v!r} (limit {lim!r}, {calls} calls)")
    result = {
        "correct": bool(correct), "attempted": n_judged, "failed": len(failed_frames),
        "metrics": metrics, "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in numbers.items()}
    return result


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in bfloat16 in the program's place (not a timed run)")
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no card: cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} of {chips} needed")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      control=args.control, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad}: no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0
