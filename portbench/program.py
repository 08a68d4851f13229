"""What the benchmark does with the program under test, `romap_tpu_torch`:
build it as a configuration file states, give it the benchmark's weights
and random draws, drive its users' entry points, and read its outputs.

One entry point, named by a traffic file's `entry`:

  offline  `runtime/offline.py::OfflineRunner` on a dataset written from the
           scene: `OfflineRunner.train`, waves of `steps_per_wave` steps and a
           mesh round every `mesh_every_waves` waves (the reference's
           OfflineNeRF schedule)

Set-up makes the program's own training state, writes the benchmark's
weights into it (the configuration's field's `init_weights`, from the
seed, on the card), gives it a random stream seeded by the benchmark, and
drives it through three steps of the window's own call
(`nerf.train_objects` as the runner calls it) whose outputs are read for
the comparison with the reference. The same object then runs the window.

The window's boundaries are read from the program's own barriers: the
harness wraps `nerf.train_objects` (a wave, then the runner's `.cpu()`)
and `OfflineRunner.extract_meshes` through the objects' attributes, and
changes nothing they do.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

import torch

from romap_tpu_torch.config import (
    EncodingConfig,
    NerfConfig,
    NetworkConfig,
    OptimizerConfig,
    TrainConfig,
)
from romap_tpu_torch.models import nerf
from romap_tpu_torch.runtime import artifacts
from romap_tpu_torch.runtime.offline import OfflineRunner

from portbench import check, registry, scene
from portbench.frozen import world
from portbench.window import Window

CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised from the mesh-round wrapper to end `OfflineRunner.train` at a
    unit boundary."""


def nerf_config(cfg: dict) -> NerfConfig:
    """The program's config from a configuration file's sections."""
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    fields = lambda cls, d: cls(**{k: tup(v) for k, v in d.items()})
    return NerfConfig(encoding=fields(EncodingConfig, cfg["encoding"]),
                      network=fields(NetworkConfig, cfg["network"]),
                      optimizer=fields(OptimizerConfig, cfg["optimizer"]),
                      train=fields(TrainConfig, cfg["train"]))


def _paths(tree: dict, prefix: str = ""):
    """(path joined with ".", tensor) of each tensor in a tree of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def leaves(params, kind: str) -> dict:
    """{reference leaf name: the program's tensor} of a params tree: the
    encoding's `table`, or `lines`, `planes{i}` and `plane_lines{i}`; then
    each tensor under `params["mlp"]` by its path below it (`w0`,
    `rgb.w2`)."""
    t = params["table"]
    out = {}
    if isinstance(t, dict):
        out["lines"] = t["lines"]
        for i, p in enumerate(t["planes"]):
            out[f"planes{i}"] = p
        for i, p in enumerate(t["plane_lines"]):
            out[f"plane_lines{i}"] = p
    else:
        out["table" if kind == "hashgrid" else "lines"] = t
    out.update(_paths(params["mlp"]))
    return out


def install(state, weights: dict, kind: str) -> None:
    """Write the benchmark's weights into params and EMA (the program's
    init makes EMA = params); the shapes must agree with the reference's."""
    with torch.no_grad():
        for tree in (state.params, state.ema):
            got = leaves(tree, kind)
            if set(got) != set(weights):
                raise RuntimeError(f"program leaves {sorted(got)} != reference {sorted(weights)}")
            for k, w in weights.items():
                if tuple(got[k].shape) != tuple(w.shape):
                    raise RuntimeError(f"leaf {k}: program {tuple(got[k].shape)}, "
                                       f"reference {tuple(w.shape)}")
                got[k].copy_(w)


@dataclasses.dataclass
class Readings:
    """The program's outputs at the checked steps: the logged loss of each
    slot after each step, the first gradient as the optimizer holds it
    (mu / (1 - beta1) after step one) and the change of the parameters and
    of their EMA (what the program renders and meshes from) after the last,
    as norms per slot and leaf; and the sign of each parameter's first
    update."""

    losses: list = dataclasses.field(default_factory=list)  # [steps][O]
    grad_norm: dict = dataclasses.field(default_factory=dict)  # leaf -> [O]
    change_norm: dict = dataclasses.field(default_factory=dict)  # leaf -> [O]
    ema_change_norm: dict = dataclasses.field(default_factory=dict)  # leaf -> [O]
    first_sign: dict = dataclasses.field(default_factory=dict)  # leaf -> int8 [O, ...]


def observe(state, params0: dict, kind: str, beta1: float, r: Readings) -> None:
    """Read one checked step's outputs from the state it returned."""
    r.losses.append(state.loss.detach().float().cpu().numpy().copy())
    norms = lambda tree: {k: torch.linalg.vector_norm(v.detach().float().flatten(1), dim=1)
                          .cpu().numpy() for k, v in tree.items()}
    if len(r.losses) == 1:
        r.grad_norm = norms({k: v / (1 - beta1) for k, v in leaves(state.opt.mu, kind).items()})
        r.first_sign = {k: torch.sign(v.detach() - params0[k]).to(torch.int8).cpu()
                        for k, v in leaves(state.params, kind).items()}
    if len(r.losses) == CHECKED_STEPS:
        now, ema = leaves(state.params, kind), leaves(state.ema, kind)
        r.change_norm = norms({k: now[k] - params0[k] for k in now})
        r.ema_change_norm = norms({k: ema[k] - params0[k] for k in ema})


class Cell:
    """One run of one cell: `setup()`, `run_window()`, `close()`. Holds
    what the reference needs: `frames`, `objects` (the object table as the
    program got it), the seeds of the weights and of the draws, the slot
    count and the checked steps' `readings`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tmp: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tmp = tmp
        self.ncfg = nerf_config(cfg)
        self.kind = cfg["encoding"]["kind"]
        self.readings = Readings()
        self.mesh_s: list[float] = []
        self.phases: dict[str, float] = {}  # set-up seconds by part
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        """Close the set-up part `name` (seconds since the last mark)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - self._t
        self._t = now

    # the checked steps' weights and draws; `check.reference` makes them again
    def weights(self, n_slots: int) -> dict:
        g = torch.Generator(device=self.device).manual_seed(check.weight_seed(self.seed))
        return registry.reference(self.cfg).init_weights(g, self.cfg, n_slots)

    def draw_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(check.draw_seed(self.seed))

    def mesh_spans(self):
        """Host clock around each object's mesh (`artifacts.extract_object_mesh`,
        as both runners call it), ending in a synchronise."""
        real = artifacts.extract_object_mesh

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.mesh_s.append(time.perf_counter() - t0)
            return out

        artifacts.extract_object_mesh = timed
        return lambda: setattr(artifacts, "extract_object_mesh", real)


# --------------------------------------------------------------------------
# offline
# --------------------------------------------------------------------------


class OfflineCell(Cell):
    def setup(self) -> None:
        t = self.traffic
        self._t = time.perf_counter()
        sc = scene.make(t["scene"], self.seed, self.device)
        self.mark("scene")
        self.root = tempfile.mkdtemp(prefix="portbench-scene-", dir=self.tmp)
        world.write_dataset(self.root, sc["cam"], scene.as_frames(sc), objects=sc["objects"],
                            use_depth=t["use_depth"])
        self.mark("dataset written")
        self.runner = OfflineRunner(self.root, self.ncfg, use_depth=t["use_depth"], mesh=True,
                                    device=self.device)
        self.runner.create_nerfs_from_dir()
        self.runner._build_object_table()
        run = self.runner
        self.n_slots = run.objs_state.capacity
        self.active = run.objs_state.active.cpu().numpy().copy()
        self.mark("runner (frames loaded)")
        w = self.weights(self.n_slots)
        install(run.state, w, self.kind)
        run.generator = self.draw_generator()
        frames = run.store.arrays()
        self.mark("weights")
        for k in range(CHECKED_STEPS):
            run.state = nerf.train_objects(run.state, run.objs_state, frames, self.ncfg,
                                           run.spec, 1, run.use_depth, generator=run.generator)
            observe(run.state, w, self.kind, self.ncfg.optimizer.beta1, self.readings)
            self.mark("first step (kernels load)" if k == 0 else "checked steps")
        del w
        run.meshes = {}
        run.extract_meshes()  # the mesh round's shapes, warmed
        self.mark("mesh warm-up")

    def reference_inputs(self):
        """Frames and object table as the reference reads them: from the
        dataset files the runner read (`reference.dataset`)."""
        from portbench.reference import dataset
        return dataset.read(self.root, self.device)

    def run_window(self, seconds: float, after=None):
        """The window over `OfflineRunner.train`; `after(window)` runs at
        the close, before the teardown. Returns the Window."""
        t, run = self.traffic, self.runner
        win = Window(seconds, t["window_units"])
        per_wave = int(self.active.sum()) * t["steps_per_wave"]
        real_train, real_mesh = nerf.train_objects, run.extract_meshes
        waves = [0]

        def train(*args, **kwargs):
            out = real_train(*args, **kwargs)
            out.loss.cpu()  # the runner's own barrier comes next; read here
            waves[0] += 1
            return out

        def meshes():
            real_mesh()
            win.close_unit(per_wave * waves[0], t["steps_per_wave"] * waves[0])
            waves[0] = 0
            if not win.want_more():
                raise WindowClosed

        nerf.train_objects, run.extract_meshes = train, meshes
        try:
            win.open()
            run.train(waves=10**9, steps_per_wave=t["steps_per_wave"],
                      mesh_every=t["mesh_every_waves"], out_dir=os.path.join(self.root, "out"))
        except WindowClosed:
            pass
        finally:
            nerf.train_objects = real_train
            del run.extract_meshes
        if after is not None:
            after(win)
        return win

    def step_inputs(self):
        run = self.runner
        return run.state, run.objs_state, run.store.arrays(), run.spec, run.use_depth

    def close(self) -> None:
        self.runner = None
        shutil.rmtree(self.root, ignore_errors=True)


ENTRIES = {"offline": OfflineCell}
