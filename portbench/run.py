"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, in order: the cell's pool of manufactured problems is drawn
from the seed and built by the cell's route (the port assembles each
right-hand side on the card, and builds or loads its kernel library inside
the checkout); the route warms every shape up; then the window solves the
pool's problems in turn, back to back from x = 0, until the first solve
that ends ``--seconds`` after the first began (with ``--trace 1``, under
``torch.profiler`` with device activity only, and at most the cell's
``trace_solves`` solves). The end-to-end metrics (``--trace 0``) or the
per-layer ones (``--trace 1``) are read from that window. Then, with the
program's state freed, the configuration's plain reference judges one
answer of each problem, drawn from the seed among that problem's solves in
the window, by each check the cell's ``limits`` name, and the last line of
standard output is the JSON result.

Every part is found by name (see :class:`Spec`): ``workloads/<cell>.json``
names its configuration, route and checks; ``configs/<config>.json`` its
domain kind (``domains/<kind>.py``), problem family (``families/``) and
reference (``reference/``); ``BENCHMARK.json`` the metrics
(``metrics/<name>.py``).

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, and 3 when a module of JAX, Flax or the JAX package is
loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import guard  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent  # the checkout: BENCHMARK.json is here
CACHE_DIRS = {  # every build and kernel cache at a fixed path inside the checkout
    "TORCH_EXTENSIONS_DIR": "build/portbench_cache/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench_cache/triton",
    "CUDA_CACHE_PATH": "build/portbench_cache/nv",
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(root / "portbench" / kind / f"{name}.json") as fh:
        return json.load(fh)


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded by its path."""
    path = root / "portbench" / kind / f"{name}.py"
    mod_name = "portbench_" + kind + "_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The manifest's metrics this cell reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    entries = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def cuda_sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


class Record:
    """What the window left for the metric readers (``metrics/<name>.py``,
    each ``read(record) -> value or None``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self._kernels = None

    @property
    def n_solves(self) -> int:
        return len(self.solves)

    def kernel_timings(self):
        """{kernel: (bytes, device ms)} of each port kernel the window
        launched, timed alone on the cell's level-0 layout; None off the
        card."""
        if self._kernels is None and self.device == "cuda":
            import torch

            from portbench import yardstick

            gen = torch.Generator(device="cuda")
            gen.manual_seed(self.seed)
            make = (yardstick.level0_cases_3d if len(self.route.op.padded_shape) == 3
                    else yardstick.level0_cases_2d)
            cases = make(self.route.op, self.route.mg, gen)
            self._kernels = yardstick.kernel_rooflines(cases, self.launches)
            del cases
            torch.cuda.empty_cache()
        return self._kernels


def card_lines() -> None:
    """The card's name, its power limit and the peak the rooflines use."""
    from portbench.yardstick import HBM_BYTES_PER_S

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi not read ({exc})"
    print(f"card: {smi}; roofline peak {HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)


class Spec:
    """Cell ``name`` and everything its files name, found by name: its
    workload file (``overrides`` replace keys of it: smaller sizes for tests
    on the CPU), its configuration, the configuration's problem family,
    plain reference and (through the reference) domain predicate, the
    cell's route and one check a key of its ``limits``."""

    def __init__(self, root: Path, name: str, overrides: dict = None):
        self.manifest = manifest(root)
        self.entry = next(w for w in self.manifest["workloads"] if w["name"] == name)
        self.cell = {**load_json(root, "workloads", name), **(overrides or {})}
        self.config = load_json(root, "configs", self.entry["config"])
        self.family = load_module(root, "families", self.config["family"]).Family
        self.reference = load_module(root, "reference", self.config["reference"])
        self.Route = load_module(root, "routes", self.cell["route"]).Route
        for key, want in getattr(self.Route, "STATES", {}).items():
            if self.cell.get(key) != want:
                raise ValueError(f"{name}: route {self.cell['route']!r} builds {key} "
                                 f"{want!r}; the cell states {self.cell.get(key)!r}")
        self.checks = {k: load_module(root, "checks", k) for k in self.cell["limits"]}

    def pool(self, seed: int) -> list:
        from portbench.problems import pool

        return pool(self.family, seed, self.cell)

    def judge(self, answers, families, solves) -> dict:
        """{check: {value, limit, failed}} of the kept answers and the
        window's solves."""
        ctx = SimpleNamespace(answers=answers, families=families, solves=solves,
                              reference=self.reference, domain=self.config["domain"],
                              n=self.cell["n"])
        out = {}
        for k, mod in self.checks.items():
            limit = self.cell["limits"][k]
            value, failed = mod.judge(ctx, limit)
            out[k] = {"value": value, "limit": limit, "failed": failed}
        return out


def _storage(t):
    return t.untyped_storage().data_ptr()


def _held_bytes(answers) -> int:
    """Device bytes the kept answers hold: their distinct storages, each
    rounded up to the caching allocator's 512-byte blocks."""
    sizes = {_storage(t): t.untyped_storage().nbytes() for t in answers}
    return sum(-(-b // 512) * 512 for b in sizes.values())


def _window(route, kept, rng, seen, solves, device, seconds, limit=None):
    """Solve the pool in turn, back to back from x = 0, until the first
    solve that ends ``seconds`` after the first began (or the ``limit``-th)
    and each problem has had one; returns the window's length, s. Each
    problem's kept answer is a reference to one of its solves' answers,
    drawn from the seed (reservoir sampling): the harness adds no device
    work. An answer that shares its storage with a kept one (a buffer the
    program hands out again) stops the run."""
    pool = len(kept)
    t_first = time.perf_counter()
    while True:
        p = len(solves) % pool
        ts = time.perf_counter()
        x, res = route.solve(p)
        cuda_sync(device)
        te = time.perf_counter()
        solves.append({"problem": p, "wall_s": te - ts, "inner": res.iterations,
                       "outer": getattr(res, "outer_iterations", None),
                       "converged": bool(res.converged)})
        if any(_storage(x) == _storage(k) for k in kept):
            raise RuntimeError("a solve returned storage it had returned before; its "
                               "earlier answer cannot be kept by reference")
        seen[p] += 1
        if rng.random() * seen[p] < 1.0:
            kept[p] = x
        del x, res
        done = te - t_first >= seconds or (limit is not None and len(solves) >= limit)
        if done and len(solves) >= pool:
            return te - t_first


def run_cell(name, seed, seconds, trace, *, device="cuda", root=ROOT, t0=None,
             overrides=None):
    """One run of cell ``name``; returns (result dict, checks dict).

    With ``trace``, the window (at most the cell's ``trace_solves`` solves)
    runs under ``torch.profiler`` with device activity only, no host ranges
    and no phase synchronisations (the host pays CUPTI's cost a launch and
    nothing more); then one more solve of the pool's
    first problem is traced with host ranges (``profiling.Profiler``'s
    phases) only to name the breakdown's idle gaps.

    A route (``routes/<route>.py``) is ``Route(cell, config, families,
    device)`` with ``warmup()`` (one answer a problem, every shape the
    window uses built), ``solve(p, profiler=None)`` -> (answer on the grid,
    result with ``iterations`` and ``converged``), ``control(p, reference)``
    and ``op`` / ``mg`` (the layout the rooflines time); where it drives
    more than this process's card (ranks it started), it adds ``close()``,
    called once the window has closed, and ``memory_peak_bytes()``, the
    fullest card's peak."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.profiling import Profiler

    t0 = _T0 if t0 is None else t0
    spec = Spec(root, name, overrides)
    cell, entry = spec.cell, spec.entry
    if device == "cuda":
        card_lines()
    fams = spec.pool(seed)
    log(f"{name}: seed {seed}, alphas {[round(f.alpha, 6) for f in fams]}")
    route = spec.Route(cell, spec.config, fams, device)
    kept = list(route.warmup())
    cuda_sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    setup_s = time.perf_counter() - t0

    rng = random.Random(seed)
    seen = [0] * len(fams)
    solves = []
    held = _held_bytes(kept)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    gc.collect()
    gc.disable()  # no collector pause lands in a solve
    if trace:
        dev_only = [torch.profiler.ProfilerActivity.CUDA if device == "cuda"
                    else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=dev_only) as prof:
            window_s = _window(route, kept, rng, seen, solves, device, seconds,
                               limit=cell["trace_solves"])
    else:
        window_s = _window(route, kept, rng, seen, solves, device, seconds)
    gc.enable()
    held = min(held, _held_bytes(kept))
    walls = [s["wall_s"] for s in solves]
    quartiles = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls
    log(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, {len(solves)} solves; walls s: "
        f"first {walls[:3]}, quartiles {quartiles}, max {max(walls)}")
    window_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rec = Record(solves=solves, setup_s=setup_s, window_s=window_s,
                 peak_bytes=window_peak - held, device=device, seed=seed, route=route,
                 launches=dict(_build.launches), trace=None)
    t_read = time.perf_counter()
    if trace:
        from portbench.yardstick import read_trace

        rec.trace = read_trace(prof)
        prof = None
        gc.collect()
        gc.disable()  # the rooflines' timers: before the named trace, no collector pause
        rec.kernel_timings()
        gc.enable()
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if device == "cuda" else [])
        with torch.profiler.profile(activities=acts) as named:
            with torch.profiler.record_function("solve"):
                route.solve(0, profiler=Profiler())
                cuda_sync(device)
        ranges = read_trace(named)
        named = None
        log(f"trace read in {time.perf_counter() - t_read:.3f} s: "
            f"{len(rec.trace['device'])} device operations; named solve "
            f"{len(ranges['device'])} and {len(ranges['ranges'])} ranges")
    metrics = {}
    for m in cell_metrics(spec.manifest, name, trace):
        value = load_module(root, "metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = max(setup_peak, window_peak)
    if hasattr(route, "memory_peak_bytes"):
        peak = route.memory_peak_bytes()
    result = {"correct": False, "attempted": len(solves), "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                         "count": entry["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(_busy(rec.trace, window_s))
        result["breakdown"] = _breakdown(rec.trace, ranges)
    # the program's state goes before the reference runs
    if hasattr(route, "close"):
        route.close()
    rec.route = route = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged = spec.judge(kept, fams, solves)
    log(f"metrics {t_ref - t_read:.3f} s, reference {time.perf_counter() - t_ref:.3f} s")
    checks = {k: {"value": v["value"], "limit": v["limit"]} for k, v in judged.items()}
    result["failed"] = sum(v["failed"] for v in judged.values())
    result["correct"] = result["failed"] == 0
    result["checks"] = checks
    return result, checks


def _busy(tr, window_s: float) -> dict:
    from portbench.yardstick import busy_us

    busy, _, _ = busy_us([(s, e) for _, s, e in tr["device"]])
    return {"busy_s": busy / 1e6, "window_s": window_s}


def _breakdown(tr, named) -> dict:
    """The window's device operations with the most time, and the named
    solve's idle gaps by the host range they fell in, seconds, at most 10
    of each."""
    from portbench.yardstick import idle_gaps, name_gaps

    ops = {}
    for n, s, e in tr["device"]:
        ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s) / 1e6
    gaps = name_gaps(idle_gaps([(s, e) for _, s, e in named["device"]]), named["ranges"])

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top({k: v / 1e6 for k, v in gaps.items()})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    guard.check("before the run")
    import torch

    torch.set_num_threads(1)  # the host drives the card from one thread
    chips = next(w["chips"] for w in manifest()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    guard.check("after the window")
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
