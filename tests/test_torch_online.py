"""The port's online slice vs romap_tpu on the CPU: manager bookkeeping on a
replayed trace, one manager wave, `reinit_slot`, the checkpoint, the socket
server, and the C++ shim against the port's server.

One JAX manager run (a module fixture) records the trace with
`romap_tpu.runtime.replay.TraceRecorder` and, after every call, its
bookkeeping; the port's manager replays the same trace and must agree after
every call. The trace covers the >10-bbox gate, a create past capacity
(`_grow`), a bbox-table overflow (`_grow_bboxes`), `update_nerf_volume`
(valid and stale) and `wait_threads_end` with the final retrain.
"""

import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from romap_tpu import config as jcfg
from romap_tpu.data.synthetic import Camera, make_scene, make_sequence
from romap_tpu.runtime.manager import NerfManagerOnline as JManager
from romap_tpu.runtime.replay import TraceRecorder
from romap_tpu.runtime.server import RuntimeServer as JServer
from romap_tpu_torch import config as tcfg
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.runtime import pose_refine
from romap_tpu_torch.runtime import server as tserver
from romap_tpu_torch.runtime.manager import NerfManagerOnline as TManager
from romap_tpu_torch.runtime.replay import replay
from romap_tpu_torch.utils import checkpoint, jax_bridge, tracing
from tests.test_torch_native_build import BUILD_ERROR

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, CAP, IMGS = 2, 1, 8  # wave length, initial slots, bbox rows per object


def configs():
    """The same tiny config for JAX and the port."""
    enc = dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
               mx_plane_res=16, mx_plane_features=4, mx_impl="xla")
    train = dict(rays_per_batch=64, samples_per_ray=4, mc_resolution=9)
    return (jcfg.NerfConfig(encoding=jcfg.EncodingConfig(**enc), train=jcfg.TrainConfig(**train)),
            tcfg.NerfConfig(encoding=tcfg.EncodingConfig(**enc), train=tcfg.TrainConfig(**train)))


def make_trace():
    """The calls of the recorded session: (name, args, kwargs)."""
    res = 32
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(2)
    frames = make_sequence(cam, objects, 14, radius=5.5)
    calls = [("dataset_init", (cam.fx, cam.fy, cam.cx, cam.cy, cam.h, cam.w, IMGS), {})]
    for fi, f in enumerate(frames):
        calls.append(("new_frame_to_dataset", (fi, f["stamp"], f["rgb"], f["instance"]),
                      {"pose": f["twc"]}))
    rows, vol = [], []
    for cls, obj in zip((1, 41), objects):
        tow = np.eye(4, dtype=np.float32)
        tow[:3, 3] = -obj.center
        half = obj.aabb_half_extents()
        calls.append(("create_nerf", (cls, tow, -half, half), {}))  # 2nd grows 1 -> 2
        rows.append([(fi, *f["bboxes"][obj.instance_id]) for fi, f in enumerate(frames)
                     if f["bboxes"][obj.instance_id] is not None][:12])
        vol.append((tow, -half * 1.3, half * 1.3))
    calls += [
        ("update_nerf_bbox", (0, rows[0][:6], 1), {}),
        ("pump", (), {}),  # 6 bboxes: gated
        ("update_nerf_bbox", (0, rows[0][6:], 2), {}),  # 12 rows > 8: table grows
        ("update_nerf_bbox", (1, rows[1], 1), {}),
        ("pump", (1,), {}),  # one wave of both slots (the wave test's)
        ("pump", (), {}),  # drain: slot 0 alone, a mesh at its 2nd wave
        ("update_nerf_volume", (1, *vol[1]), {}),
        ("update_nerf_volume", (5, *vol[1]), {}),  # stale slot: no-op
        ("pump", (), {}),
        ("wait_threads_end", (), {}),  # final retrain, drain, final wave
    ]
    return calls


def bookkeeping(m, ret):
    objs = {k: v.copy() for k, v in (m._objs or {}).items()}
    return dict(ret=ret, pending=m._pending_waves.copy(), waves=m._wave_count.copy(),
                earned=m._waves_earned.copy(), reinits=m._reinit_count.copy(),
                capacity=m.capacity, max_bboxes=getattr(m, "_max_bboxes", None), objs=objs,
                meshes=sorted(int(k) for k in m._meshes))


@pytest.fixture(scope="module")
def jax_session():
    """Run the trace through the JAX manager, recording it with
    TraceRecorder, the bookkeeping after every call, and the state around
    the first training wave."""
    jc, _ = configs()
    mgr = JManager(jc, train_step_iterations=ITERS, capacity=CAP)
    rec = TraceRecorder(mgr)
    books, around_wave = [], {}
    for name, args, kwargs in make_trace():
        if name == "pump" and args == (1,):
            around_wave["before"] = jax.device_get(mgr.state)
        if name in ("update_nerf_volume",):  # not one of replay.RECORDED
            rec.trace.append((name, args, kwargs))
        ret = getattr(rec, name)(*args, **kwargs)
        books.append(bookkeeping(mgr, ret))
        if name == "pump" and args == (1,):
            around_wave["after"] = jax.device_get(mgr.state)
            around_wave["index"] = len(books) - 1
    return rec.trace, books, around_wave


def assert_book_equal(got, want, where):
    assert got["ret"] == want["ret"], where
    for k in ("pending", "waves", "earned", "reinits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where}: {k}")
    assert (got["capacity"], got["max_bboxes"], got["meshes"]) == (
        want["capacity"], want["max_bboxes"], want["meshes"]), where
    assert sorted(got["objs"]) == sorted(want["objs"]), where
    for k, v in want["objs"].items():
        np.testing.assert_array_equal(got["objs"][k], v, err_msg=f"{where}: _objs[{k}]")


def test_manager_bookkeeping_matches_jax_on_replayed_trace(jax_session):
    trace, books, _ = jax_session
    assert [name for name, *_ in trace].count("update_nerf_volume") == 2
    _, tc = configs()
    mgr = TManager(tc, train_step_iterations=ITERS, capacity=CAP, device="cpu")
    for i, (name, args, kwargs) in enumerate(trace):
        ret = getattr(mgr, name)(*args, **kwargs)
        assert_book_equal(bookkeeping(mgr, ret), books[i], f"call {i} {name}{args[:1]}")
    assert books[-1]["capacity"] == 2 and books[-1]["max_bboxes"] == 16
    losses = mgr.losses()
    assert losses.shape == (2,) and np.isfinite(losses).all()
    # replay.replay drives a fresh manager through the same calls
    again = TManager(tc, train_step_iterations=ITERS, capacity=CAP, device="cpu")
    replay(trace, again)
    assert_book_equal(bookkeeping(again, None), dict(books[-1], ret=None), "replay()")


def jax_uniforms(keys, cfg):
    """The uniforms JAX's _object_train_step draws for one step, per object
    (as tests/test_torch_train.py)."""
    r, s = cfg.train.rays_per_batch, cfg.train.samples_per_ray

    def one(key):
        key, k_batch = jax.random.split(key)
        k_xy, k_color, k_jitter = jax.random.split(k_batch, 3)
        return key, (jax.random.uniform(k_xy, (r, 2)), jax.random.uniform(k_color, (r, 3)),
                     jax.random.uniform(k_jitter, (r, s)))

    return jax.vmap(one)(keys)


def replay_uniforms(keys, cfg):
    box = [keys]

    def draw():
        box[0], u = jax_uniforms(box[0], cfg)
        return tuple(torch.from_numpy(np.array(a)) for a in u)

    return draw


def test_manager_wave_matches_jax(jax_session):
    """The trace's first training wave, from JAX's state bridged into the
    port's manager and JAX's uniforms replayed: loss, steps and Adam count
    exact, params and EMA within test_torch_train's share tolerance."""
    trace, _, around = jax_session
    jc, tc = configs()
    mgr = TManager(tc, train_step_iterations=ITERS, capacity=CAP, device="cpu")
    replay(trace[: around["index"]], mgr)
    before, want = around["before"], around["after"]
    mgr.state = jax_bridge.train_state_from_jax(before)
    mgr.uniforms = replay_uniforms(before.key, jc)
    assert mgr.pump(1) == 1
    got = jax_bridge.train_state_to_numpy(mgr.state)
    np.testing.assert_array_equal(got["step"], want.step)
    assert got["step"].tolist() == [ITERS, ITERS]
    np.testing.assert_array_equal(got["opt_state"][1], want.opt_state[2].count)
    np.testing.assert_allclose(got["loss"], want.loss, rtol=1e-4, atol=1e-6)
    for name, a, b in (("params", got["params"], want.params), ("ema", got["ema"], want.ema)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            tol = 1e-5 * (np.abs(y).max() + 1e-30) + 1e-4 * np.abs(y)
            assert float(np.mean(np.abs(x - y) <= tol)) >= 0.999, (name, x.shape)


def test_reinit_slot_rewrites_one_row():
    _, tc = configs()
    spec = tnerf.make_field_spec(tc)
    g = torch.Generator().manual_seed(0)
    s0 = tnerf.init_train_state(g, 3, tc, spec)
    s0 = s0._replace(step=s0.step + 5, loss=torch.ones(3),
                     opt=s0.opt._replace(mu=pytree.tree_map(torch.ones_like, s0.opt.mu),
                                         count=s0.opt.count + 5))
    old = pytree.tree_map(torch.clone, s0)
    s1 = tnerf.reinit_slot(s0, torch.Generator().manual_seed(1), 1, tc, spec)
    for a, b in zip(pytree.tree_leaves(old), pytree.tree_leaves(s0)):
        assert torch.equal(a, b)  # the old state is left as it was
    for a, b in zip(pytree.tree_leaves(old), pytree.tree_leaves(s1)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert s1.step.tolist() == [5, 0, 5] and s1.loss.tolist() == [1.0, 0.0, 1.0]
    assert s1.opt.count[1] == 0
    for mu, nu in zip(pytree.tree_leaves(s1.opt.mu), pytree.tree_leaves(s1.opt.nu)):
        assert not mu[1].any() and not nu[1].any()
    for p, e, q in zip(pytree.tree_leaves(s1.params), pytree.tree_leaves(s1.ema),
                       pytree.tree_leaves(old.params)):
        assert torch.equal(p[1], e[1]) and not torch.equal(p[1], q[1])
    # two reinits of one slot through the manager draw different params
    mgr = TManager(tc, train_step_iterations=1, capacity=2, device="cpu")
    mgr.dataset_init(10.0, 10.0, 8.0, 8.0, 16, 16, 4)
    idx = mgr.create_nerf(1, np.eye(4), -np.ones(3), np.ones(3))
    draws = []
    for _ in range(2):
        assert mgr.update_nerf_volume(idx, np.eye(4), -np.ones(3), np.ones(3))
        draws.append(mgr.state.params["table"]["lines"][idx].clone())
    assert not torch.equal(draws[0], draws[1])
    assert mgr._reinit_count[idx] == 2


def test_checkpoint_round_trips_exactly(tmp_path):
    _, tc = configs()
    spec = tnerf.make_field_spec(tc)
    g = torch.Generator().manual_seed(3)
    state = tnerf.init_train_state(g, 2, tc, spec)
    state = state._replace(step=torch.tensor([7, 0], dtype=torch.int32),
                           loss=torch.rand(2, generator=g))
    objs = tnerf.empty_objects(2, 5)
    path = str(tmp_path / "state.pt")
    checkpoint.save_checkpoint(path, state, objs, extra={"n_objects": 2})
    raw = checkpoint.load_checkpoint(path)
    assert raw["extra"] == {"n_objects": 2}
    back = checkpoint.restore_train_state(raw["state"], tnerf.init_train_state(
        torch.Generator().manual_seed(9), 2, tc, spec))
    assert type(back) is type(state)
    assert pytree.tree_structure(back) == pytree.tree_structure(state)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back_objs = checkpoint.restore_objects(raw["objects"])
    for a, b in zip(back_objs, objs):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "missing.pt"))


def test_session_checkpoint_continues_the_random_stream(tmp_path, monkeypatch):
    """The ROMAP_SAVE_STATE checkpoint holds the manager's generator state
    (the reference's holds each object's key): a generator restored from it
    draws the same next uniforms as the manager's own, and the session has
    moved the stream away from a fresh generator's."""
    _, tc = configs()
    path = str(tmp_path / "session.pt")
    monkeypatch.setenv("ROMAP_SAVE_STATE", path)
    mgr = TManager(tc, train_step_iterations=ITERS, capacity=CAP, device="cpu")
    replay(make_trace(), mgr)
    raw = checkpoint.load_checkpoint(path)
    restored = checkpoint.restore_generator(raw["extra"]["generator"], "cpu")
    want = tnerf.draw_uniforms(mgr._gen, mgr.capacity, tc)
    got = tnerf.draw_uniforms(restored, mgr.capacity, tc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fresh = tnerf.draw_uniforms(torch.Generator().manual_seed(tc.seed), mgr.capacity, tc)
    assert not torch.equal(fresh[0], want[0])
    back = checkpoint.restore_train_state(raw["state"], mgr.state)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(mgr.state)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The socket server
# --------------------------------------------------------------------------


def pack_str(s: str) -> bytes:
    return struct.pack("<H", len(s)) + s.encode()


def f32(a) -> bytes:
    return np.asarray(a, np.float32).tobytes()


class Client:
    def __init__(self, path: str, timeout: float):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(path)

    def call(self, op: int, payload: bytes = b"") -> tuple[int, bytes]:
        self.sock.sendall(struct.pack("<II", op, len(payload)) + payload)
        status, n = struct.unpack("<II", self._recv(8))
        return status, self._recv(n)

    def _recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "server closed the connection"
            buf += chunk
        return buf


def wait_for(path: str, alive, seconds: float) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert alive(), "server exited before its socket appeared"
        assert time.monotonic() - t0 < seconds, "server socket never appeared"
        time.sleep(0.05)


def session_payloads():
    """(opcode, payload) of a short session whose replies are deterministic."""
    res = 32
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(2)
    frames = make_sequence(cam, objects, 4, radius=5.5)
    ops = tserver.OPS
    msgs = [(ops["INIT"], struct.pack("<BiiB", 0, 3, 1, 1)),
            (ops["DATASET_INIT"], struct.pack("<ffffiii", cam.fx, cam.fy, cam.cx, cam.cy,
                                               res, res, 8))]
    for fi, f in enumerate(frames):
        msgs.append((ops["NEW_FRAME"], struct.pack("<i", fi) + pack_str(f["stamp"]) + b"\0"
                     + f["rgb"].tobytes() + f["instance"].tobytes() + f32(f["twc"])))
    for idx, (cls, obj) in enumerate(zip((1, 73), objects)):
        tow = np.eye(4)
        tow[:3, 3] = -obj.center
        half = obj.aabb_half_extents()
        msgs.append((ops["CREATE_NERF"], struct.pack("<i", cls) + f32(tow) + f32(-half)
                     + f32(half)))
        box = frames[0]["bboxes"][obj.instance_id]
        msgs.append((ops["UPDATE_BBOX"], struct.pack("<iii", idx, 1, 1)
                     + np.asarray([0, *box], np.int32).tobytes()))
    msgs += [(ops["GET_FRAME_IDX"], pack_str(frames[2]["stamp"])),
             (ops["GET_FRAME_IDX"], pack_str("no such stamp")),
             (ops["UPDATE_VOLUME"], struct.pack("<i", 1) + f32(np.eye(4)) + f32([-.5, -.4, -.3])
              + f32([.5, .4, .3])),
             (ops["UPDATE_VOLUME"], struct.pack("<i", 7) + f32(np.eye(4)) + f32(-np.ones(3))
              + f32(np.ones(3))),
             (ops["GET_LOSSES"], b"")]
    return msgs, frames


def test_server_replies_match_jax(tmp_path, monkeypatch, capsys):
    """The port's server (main(), --small --device cpu, on a thread) over a
    real UNIX socket answers as romap_tpu's RuntimeServer.handle where the
    replies are deterministic; an unknown opcode gets status 1; a
    RENDER_TEST with pixel crops refines the view's pose (2 steps of 64
    pixels x 8 samples here, to keep the CPU test short), renders it and
    replies 0."""
    monkeypatch.setattr(pose_refine, "N_STEPS", 2)
    monkeypatch.setattr(pose_refine, "N_PIXELS", 64)
    monkeypatch.setattr(pose_refine, "N_SAMPLES", 8)
    sock = str(tmp_path / "s.sock")
    th = threading.Thread(target=tserver.main,
                          args=(["--socket", sock, "--small", "--device", "cpu"],), daemon=True)
    th.start()
    wait_for(sock, th.is_alive, 30)
    jsrv = JServer(jcfg.NerfConfig(
        encoding=jcfg.EncodingConfig(kind="mxgrid", mx_levels=3, mx_max_resolution=64,
                                     mx_features=16, mx_plane_res=32, mx_plane_features=8),
        train=jcfg.TrainConfig(rays_per_batch=512, samples_per_ray=16, mc_resolution=17)))
    assert tserver.small_config().encoding.n_output_dims == 16 + 3 * 8
    client = Client(sock, timeout=60)
    msgs, frames = session_payloads()
    compared = 0
    for op, payload in msgs:
        status, reply = client.call(op, payload)
        assert status == 0, reply
        want = jsrv.handle(op, payload)
        if op == tserver.OPS["GET_LOSSES"]:
            assert reply[:4] == want[:4] == struct.pack("<i", 2)
        else:
            assert reply == want, op
        compared += op in (4, 6, 15, 11)
    assert compared == 7
    status, msg = client.call(99)
    assert status == 1 and b"unknown opcode" in msg
    x, y, h, w = frames[1]["bboxes"][1]
    render = (struct.pack("<ifB", 0, 1.0, 0) + pack_str(str(tmp_path / "out"))
              + struct.pack("<i", 1) + pack_str(frames[1]["stamp"])
              + np.asarray([x, y, h, w], np.int32).tobytes() + f32(frames[1]["twc"]) + b"\1"
              + np.ascontiguousarray(frames[1]["rgb"][y : y + h, x : x + w]).tobytes()
              + ((frames[1]["instance"][y : y + h, x : x + w] == 1) * 255).astype(np.uint8).tobytes())
    status, msg = client.call(tserver.OPS["RENDER_TEST"], render)
    assert status == 0, msg
    assert os.path.isfile(tmp_path / "out" / "0" / "test_img" / f"{frames[1]['stamp']}.png")
    assert "pose refine: object 0: " in capsys.readouterr().out
    assert client.call(tserver.OPS["SHUTDOWN"]) == (0, b"")
    th.join(timeout=30)
    assert not th.is_alive() and not os.path.exists(sock)


def test_server_trace_records_waves_and_meshes(tmp_path):
    """`--trace PATH`: at SHUTDOWN the server writes the session's spans and
    counters. Each manager wave has its `train.wave` and `train.barrier` and
    its counters (2 slots x 3 steps issued, object 0's 3 trained: object 1
    has too few bboxes; the optimizer's `optimizer.fused_params`, the same
    tree each wave), each mesh its `mesh.object` with the object's id."""
    sock, path = str(tmp_path / "s.sock"), str(tmp_path / "trace.json")
    th = threading.Thread(target=tserver.main, daemon=True, args=(
        ["--socket", sock, "--small", "--device", "cpu", "--trace", path],))
    th.start()
    ops = tserver.OPS
    msgs, _ = session_payloads()
    msgs = msgs[: [op for op, _ in msgs].index(ops["GET_FRAME_IDX"])]
    row = next(p for op, p in msgs if op == ops["UPDATE_BBOX"])[12:]  # object 0's
    msgs += [(ops["UPDATE_BBOX"], struct.pack("<iii", 0, 1, 10) + row * 10),  # 11 > 10 rows
             (ops["PUMP"], struct.pack("<i", -1)), (ops["WAIT_END"], b""),
             (ops["SHUTDOWN"], b"")]
    try:
        wait_for(sock, th.is_alive, 30)
        client = Client(sock, timeout=120)
        for op, payload in msgs:
            status, reply = client.call(op, payload)
            assert status == 0, reply
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        tracing.disable()
        tracing.drain()
    with open(path) as f:
        t = json.load(f)
    spans = [e for e in t["traceEvents"] if e["ph"] == "X"]
    waves = [e["args"]["wave"] for e in spans if e["name"] == "train.wave"]
    assert len(waves) >= 3 and waves == list(range(1, len(waves) + 1))
    assert [e["args"]["wave"] for e in spans if e["name"] == "train.barrier"] == waves
    per_wave = {}
    for c in t["counters"]:
        if "wave" in c["ids"]:
            per_wave.setdefault(c["ids"]["wave"], {})[c["name"]] = c["n"]
    fused = {per_wave[w].pop("optimizer.fused_params") for w in waves}
    assert len(fused) == 1 and fused.pop() > 0  # every step's update counts its tree
    assert per_wave == {w: {"slot_steps_issued": 2 * 3, "slot_steps_trained": 3,
                            "slots_active": 1, "train.graph_captures": 0,
                            "train.graph_replays": 0} for w in waves}
    meshes = [e for e in spans if e["name"] == "mesh.object"]
    assert meshes and all(e["args"]["object"] == 0 for e in meshes)
    verts = [c for c in t["counters"] if c["name"] == "mesh.verts"]
    assert len(verts) == len(meshes) and all(c["ids"]["object"] == 0 for c in verts)
    assert t["summary"]["spans"]["mesh.object/mesh.density"]["count"] == len(meshes)


def test_server_rejects_joint_ba_and_a_missing_card(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        tserver.main(["--socket", str(tmp_path / "s"), "--joint-ba", "5", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="joint"):
        TManager(configs()[1], joint_ba_iters=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.RuntimeServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TManager(configs()[1])


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_cpp_manager_smoke_against_torch_server(tmp_path):
    """native/build/manager_smoke (the C++ shim's end-to-end check) against
    `python -m romap_tpu_torch.runtime.server --small --device cpu`."""
    assert BUILD_ERROR is None, BUILD_ERROR  # built at import (tests/test_torch_native_build.py)
    smoke = os.path.join(REPO, "native", "build", "manager_smoke")
    sock = str(tmp_path / "monerf.sock")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    server = subprocess.Popen(
        [sys.executable, "-m", "romap_tpu_torch.runtime.server", "--socket", sock, "--small",
         "--device", "cpu"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for(sock, lambda: server.poll() is None, 60)
        out = subprocess.run([smoke, sock], capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, f"stdout={out.stdout} stderr={out.stderr}"
        assert out.stdout.startswith("OK"), out.stdout
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()
