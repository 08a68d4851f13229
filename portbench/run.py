"""One run of one cell of the port's benchmark on one GPU.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `romap_tpu_torch`. The run pins
itself to a few physical cores local to the card, sets up the cell
(scene, program, weights, three checked steps; `portbench/program.py`),
measures whole mesh periods for up to `--seconds` (`portbench/window.py`),
then compares the checked steps with the plain reference
(`portbench/check.py`) and prints one JSON line last on standard output:

  correct, attempted, failed   the comparison; the checked object slots
  metrics   with --trace 0 the cell's end-to-end metrics (obj_iters_per_s
            over the window's whole units, setup_s from the process's start
            to the window's); with --trace 1 its per-layer metrics, read by
            `portbench/metrics/<name>.py` from the window, ten unprofiled
            steps (host issue) and five profiled ones, over which alone the
            program's own tracing (`romap_tpu_torch.utils.tracing`) is on, so
            that the device trace carries the program's spans
  device    platform, card name, count, peak memory (with --trace 1 also
            busy_s and window_s of the profiled steps)
  breakdown (--trace 1) the device operations and idle gaps that took most
  compared  each number compared, with its limit (also the last lines on
            standard error)

Without a CUDA card, or with JAX or the JAX package loaded once the window
has closed, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "romap_tpu")
HOST_ISSUE_STEPS, PROFILED_STEPS = 10, 5


def process_age() -> float:
    """Seconds since this process started (/proc), or since this module
    was imported where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def pin_cores(n: int = 4) -> list[int]:
    """Pin this process (threads started later inherit it) to `n` physical
    cores local to the card's NUMA node: the PCI device's local_cpulist,
    one hardware thread a core. Where that cannot be read, the first `n`
    cores allowed."""
    allowed = sorted(os.sched_getaffinity(0))
    local = allowed
    try:
        bus = subprocess.run(["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.split()[0]
        dom, rest = bus.split(":", 1)
        path = f"/sys/bus/pci/devices/{dom[-4:].lower()}:{rest.lower()}/local_cpulist"
        with open(path) as f:
            cpus = []
            for part in f.read().strip().split(","):
                a, _, b = part.partition("-")
                cpus += range(int(a), int(b or a) + 1)
        local = [c for c in allowed if c in set(cpus)] or allowed
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        pass
    chosen, cores = [], set()
    for c in local:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/core_id") as f:
                core = f.read().strip()
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/physical_package_id") as f:
                core = (f.read().strip(), core)
        except OSError:
            core = c
        if core not in cores:
            cores.add(core)
            chosen.append(c)
    chosen = (chosen if len(chosen) >= n else local)[:n]
    os.sched_setaffinity(0, chosen)
    return chosen


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load(workload: str, overrides: dict | None = None) -> dict:
    """The cell by name (`registry.cell`), with `overrides` ({"config":
    {...}, "traffic": {...}}, merged one section deep) for the tests."""
    from portbench import registry

    c = registry.cell(workload)
    for part, upd in (overrides or {}).items():
        for k, v in upd.items():
            c[part][k] = {**c[part][k], **v} if isinstance(v, dict) else v
    return c


def program_tracing():
    """The program's tracing module, or None where the program has none."""
    try:
        from romap_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def program_cell(c: dict, seed: int, dev):
    """The program, set up as the cell states (`program.ENTRIES`); `setup()`
    runs its three checked steps."""
    from portbench.program import ENTRIES

    for var in ("MX_SNAP", "MX_FUSED"):
        if var in os.environ:
            raise RuntimeError(f"{var} is set: the configuration file states the path")
    return ENTRIES[c["traffic"]["entry"]](c["config"], c["traffic"], seed, dev,
                                          tempfile.gettempdir())


def checked_facts(cell) -> dict:
    """What the comparison needs of a set-up cell, read before `close()`."""
    frames, objects = cell.reference_inputs()
    return dict(frames=frames, objects=objects, active=cell.active.copy(),
                n_slots=cell.n_slots, readings=cell.readings)


def judged(c: dict, seed: int, facts: dict, dev) -> tuple[dict, dict]:
    """(the numbers compared, the reference's readings): the plain
    reference over the checked steps, once the program's state is freed."""
    from portbench import check

    refr = check.reference(c["config"], seed, facts["n_slots"], len(facts["readings"].losses),
                           facts["frames"], facts["objects"], dev)
    return check.numbers(facts["readings"], refr, facts["active"]), refr


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, fault=None, log=None) -> dict:
    """The run without the look for a card: returns the result line's dict.
    `overrides` (see `load`) and `fault` (a context manager planted around
    the program) are for the tests."""
    import contextlib

    import torch

    from portbench import check, counts, registry
    from portbench.trace import STEP_SPANS, read as read_trace
    from romap_tpu_torch.models import nerf

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    c = load(workload, overrides)
    cfg = c["config"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = program_cell(c, seed, dev)
    extra = {}
    with fault if fault is not None else contextlib.nullcontext():
        log(f"imports: {process_age():.3f} s")
        cell.setup()
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        undo_mesh = cell.mesh_spans() if trace else None

        def traced(win):
            extra["peak_window"] = torch.cuda.max_memory_allocated() if cuda else 0
            st, objs, frames, spec, use_depth = cell.step_inputs()
            g = torch.Generator(device=dev).manual_seed(seed % (2**63))
            step = lambda n: nerf.train_objects(st, objs, frames, cell.ncfg, spec, n, use_depth,
                                                generator=g)
            issue = []
            for _ in range(HOST_ISSUE_STEPS):
                sync()
                t0 = time.perf_counter()
                step(1)
                issue.append(time.perf_counter() - t0)
            sync()
            spans = program_tracing()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                if spans is not None:
                    spans.enable()
                try:
                    t0 = time.perf_counter()
                    step(PROFILED_STEPS)
                    sync()
                    wall = time.perf_counter() - t0
                finally:
                    if spans is not None:
                        spans.disable()
                        spans.drain()
            path = os.path.join(tempfile.gettempdir(), f"portbench-trace-{os.getpid()}.json")
            prof.export_chrome_trace(path)
            try:
                extra["profile"] = read_trace(path, STEP_SPANS)
            finally:
                os.unlink(path)
            extra.update(host_issue_s=issue, profiled_wall_s=wall)

        def sync():
            if cuda:
                torch.cuda.synchronize()

        try:
            win = cell.run_window(seconds, after=traced if trace else None)
        finally:
            if undo_mesh:
                undo_mesh()
        setup_s = process_age() - (time.perf_counter() - win.t0)
        log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in cell.phases.items())
            + f"; to the window {setup_s:.3f} s")
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = loaded_forbidden()
        if found:
            raise ForbiddenModules(found)
        facts = checked_facts(cell)
        active, n_slots = facts["active"], facts["n_slots"]
        ctx = dict(entry=c["traffic"]["entry"], slots=n_slots, objects=int(active.sum()),
                   window=win, mesh_s=list(cell.mesh_s), **extra)
        cell.close()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window and the program's state
    t_ref = time.perf_counter()
    numbers, _ = judged(c, seed, facts, dev)
    correct, compared = check.judge(numbers, c["limits"])
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")

    metrics = {}
    if not trace:
        metrics["obj_iters_per_s"] = win.rate()
        metrics["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in c["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units}
    else:
        ctx.update(work=counts.of(cfg, n_slots, dev), peak_window_bytes=extra.get("peak_window", 0),
                   obj_iters_per_s=win.rate(), step_s=win.step_seconds(),
                   profiled_steps=PROFILED_STEPS)
        for m in c["per_layer"]:
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": correct,
        "attempted": int(active.sum()),
        "failed": 0 if correct else int(active.sum()),
        "metrics": metrics,
        "device": dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                       count=1, memory_peak_bytes=int(max(setup_peak, window_peak))),
    }
    if trace and "profile" in extra:
        prof = extra["profile"]
        out["device"].update(busy_s=prof["busy_s"], window_s=extra["profiled_wall_s"])
        out["breakdown"] = {"device_ops": [list(x) for x in prof["device_ops"]],
                            "idle_gaps": [list(x) for x in prof["idle_gaps"]]}
    out["window"] = dict(units=len(win.units), seconds=win.window_s,
                         unit_s=[u.seconds for u in win.units])
    out["compared"] = compared
    return out


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    cores = pin_cores()
    import torch

    from portbench import registry

    chips = registry.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}, cores {cores}",
          file=sys.stderr, flush=True)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"portbench: modules loaded that the port may not use: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules loaded that the port may not use: {found}", file=sys.stderr)
        return 2
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
