"""Serving through captured calls (``adsr_tpu_torch/core/graphs.py``) on the
CPU: what each path would capture (DRCT's and DRN-L's) makes no tensor from
host data and never waits for the device, ``CapturedCall`` runs its function
as it is on the CPU, ``AnomalyServer`` gives each class one input shape, the
capture state machine (warm-up, capture, replay) on a stand-in for
``torch.cuda``, and the one-transfer SSIM window sweep against the JAX
package's."""

import contextlib

import numpy as np
import pytest
import torch

from adsr_tpu.eval import evaluate as jev

from adsr_tpu_torch.core import config as pc
from adsr_tpu_torch.core.graphs import CapturedCall
from adsr_tpu_torch.eval import evaluate as pev
from adsr_tpu_torch.eval.serving import AnomalyServer
from adsr_tpu_torch.train.trainer import (make_serving_forward,
                                          make_tiled_serving_forward)

from torch_port_util import CONFIGS, port_state_dict
from test_torch_serving import _drn_carpet, _experiments, _weights

HOST_DATA = ("tensor", "as_tensor", "from_numpy")
HOST_SYNCS = ("item", "cpu", "numpy", "tolist")


@contextlib.contextmanager
def host_traffic(monkeypatch):
    """Records every tensor made from host data (``torch.tensor``,
    ``torch.as_tensor`` or ``torch.from_numpy`` of anything but a tensor)
    and every call that waits for the device and copies to the host
    (``Tensor.item`` / ``cpu`` / ``numpy`` / ``tolist``): under a CUDA
    graph's capture each of them fails or bakes a stale copy in."""
    seen = []
    with monkeypatch.context() as mp:
        for name in HOST_DATA:
            def made(data, *args, _orig=getattr(torch, name), _name=name,
                     **kwargs):
                if not isinstance(data, torch.Tensor):
                    seen.append(f"torch.{_name}")
                return _orig(data, *args, **kwargs)
            mp.setattr(torch, name, made)
        for name in HOST_SYNCS:
            def synced(self, *args, _orig=getattr(torch.Tensor, name),
                       _name=name, **kwargs):
                seen.append(f"Tensor.{_name}")
                return _orig(self, *args, **kwargs)
            mp.setattr(torch.Tensor, name, synced)
        yield seen


def _rgb_experiment():
    kw = dict(resolution=16, patch_size=16, scale=(2,), n_colors=3,
              batch_size=4, test_every=1)
    return pc.Experiment(model=pc.DRCTModelConfig(**CONFIGS["rgb"]),
                         data=pc.DataConfig(**kw), precision="fp32")


def _captured_body(path):
    """(the function the path's CapturedCall would capture, its inputs as
    the CapturedCall hands them over: tensors on the device)."""
    _, pexp = _experiments()
    _, sd = _weights()
    rng = np.random.RandomState(0)
    if path.endswith("_drn"):
        # a tiny DRN-L x4 carpet class (RGB): the eager module, bicubic
        # matrices built on the device
        _, pexp, _, sd = _drn_carpet()
        lr = torch.from_numpy((rng.rand(4, 4, 4, 3) * 255).astype(np.float32))
        if path == "serving_drn":
            return make_serving_forward(pexp, sd, device="cpu").fn, (lr,)
        if path == "tiled_drn":
            return make_tiled_serving_forward(
                pexp, sd, tile=2, overlap=1, device="cpu").fn, (lr,)
        server = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
        server.register("carpet", pexp, sd)
        hr = torch.from_numpy(rng.randint(0, 256, (4, 16, 16, 3), np.uint8))
        return server._entries["carpet"].fn, (lr.to(torch.uint8), hr)
    if path in ("serving_rdg", "serving_block"):
        fwd = make_serving_forward(pexp, sd, device="cpu",
                                   mode=path.split("_")[1])
        return fwd.fn, (torch.from_numpy(
            (rng.rand(4, 8, 8, 1) * 255).astype(np.float32)),)
    if path in ("tiled_rdg", "tiled_block"):
        fwd = make_tiled_serving_forward(pexp, sd, tile=8, overlap=2,
                                         device="cpu",
                                         mode=path.split("_")[1])
        return fwd.fn, (torch.from_numpy(
            (rng.rand(2, 16, 16, 1) * 255).astype(np.float32)),)
    exp, sd = ((pexp, sd) if path == "server_gray"
               else (_rgb_experiment(), port_state_dict("rgb")))
    server = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    server.register("class", exp, sd, mode="rdg")
    lr = torch.from_numpy(rng.randint(0, 256, (4, 8, 8, 3), np.uint8))
    hr = torch.from_numpy(rng.randint(0, 256, (4, 16, 16, 3), np.uint8))
    return server._entries["class"].fn, (lr, hr)


@pytest.mark.parametrize("path", ["serving_rdg", "serving_block",
                                  "tiled_rdg", "tiled_block", "server_gray",
                                  "server_rgb", "serving_drn", "tiled_drn",
                                  "server_drn"])
def test_captured_body_makes_no_host_tensor_and_never_syncs(path,
                                                           monkeypatch):
    fn, inputs = _captured_body(path)
    want = fn(*inputs)                    # the warm-up: caches fill here
    with host_traffic(monkeypatch) as seen:
        got = fn(*inputs)
    assert seen == []
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["serving", "tiled", "server"])
def test_cpu_route_runs_the_function_as_it_is(entry, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was asked for on the CPU")
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    _, pexp = _experiments()
    _, sd = _weights()
    rng = np.random.RandomState(2)
    if entry == "server":
        lr = rng.randint(0, 256, (6, 8, 8, 1), np.uint8)
        hr = rng.randint(0, 256, (6, 16, 16, 1), np.uint8)
        calls = [AnomalyServer(batch_size=4, ssim_window=5, device="cpu",
                               graphs=g) for g in (True, False)]
        for server in calls:
            server.register("grid", pexp, sd)
        runs = [[s.score("grid", lr, hr) for _ in range(3)] for s in calls]
        assert not calls[0]._entries["grid"].signatures()
        for got in runs[0] + runs[1]:
            np.testing.assert_array_equal(got, runs[1][0])
        return
    lr = (rng.rand(2, 16, 16, 1) * 255).astype(np.float32)
    if entry == "serving":
        make = lambda g: make_serving_forward(pexp, sd, device="cpu",
                                              graphs=g)
        lr = lr[:, :8, :8]
    else:
        make = lambda g: make_tiled_serving_forward(pexp, sd, tile=8,
                                                    overlap=2, device="cpu",
                                                    graphs=g)
    fwd = make(True)
    assert not fwd.capture
    want = fwd.fn(torch.from_numpy(np.ascontiguousarray(lr)))
    for got in [fwd(lr) for _ in range(3)] + [make(False)(lr)]:
        assert torch.equal(got, want)
    assert fwd.signatures() == [] and fwd.captured() == 0


@pytest.mark.parametrize("n", [3, 4, 11])
def test_server_hands_each_batch_to_one_shape(n):
    _, pexp = _experiments()
    _, sd = _weights()
    server = AnomalyServer(batch_size=4, ssim_window=5, device="cpu")
    server.register("grid", pexp, sd)
    inner = server._entries["grid"]
    shapes = []

    def recording(lr, hr):
        shapes.append((lr.shape, lr.dtype, hr.shape, hr.dtype))
        return inner(lr, hr)

    server._entries["grid"] = recording
    rng = np.random.RandomState(n)
    lr = rng.randint(0, 256, (n, 8, 8, 1), np.uint8)
    hr = rng.randint(0, 256, (n, 16, 16, 1), np.uint8)
    scores = server.score("grid", lr, hr)
    assert scores.shape == (n, 3) and np.isfinite(scores).all()
    assert len(shapes) == -(-n // 4)
    assert set(shapes) == {((4, 8, 8, 1), np.dtype(np.uint8),
                            (4, 16, 16, 1), np.dtype(np.uint8))}


class _FakeCuda:
    """Just enough of ``torch.cuda`` for ``CapturedCall``'s capture route on
    CPU tensors: a "capture" runs the function once (as a capture records
    it), a "replay" runs it again on the static inputs into the static
    output, and each step is logged."""

    def __init__(self, monkeypatch, fail_capture=False):
        self.log = []
        self.fail_capture = fail_capture
        fake = self

        class Graph:
            def replay(self):
                fake.log.append("replay")
                self.out.copy_(self.fn(*self.inputs))

        @contextlib.contextmanager
        def graph(g):
            fake.log.append("capture")
            fake.capturing = g
            yield
            fake.capturing = None
            if fake.fail_capture:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing")

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        @contextlib.contextmanager
        def stream(s):
            fake.log.append("side stream")
            yield

        self.capturing = None
        for name, value in (("CUDAGraph", Graph), ("graph", graph),
                            ("Stream", Stream), ("stream", stream),
                            ("current_stream", lambda device=None: Stream())):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(torch.Tensor, "record_stream",
                            lambda self, s: None)

    def wrap(self, fn):
        """``fn`` that, while captured, hands the fake graph what it needs
        to replay (a real capture records the launches instead)."""
        def body(*inputs):
            out = fn(*inputs)
            self.log.append("fn")
            if self.capturing is not None:
                g = self.capturing
                g.fn, g.inputs, g.out = fn, inputs, out
            return out
        return body


def test_capture_state_machine_warms_captures_then_replays(monkeypatch):
    fake = _FakeCuda(monkeypatch)
    cc = CapturedCall(fake.wrap(lambda x: x * 2.0 + 1.0), "cpu")
    cc.capture = True                  # the card's route, on CPU tensors
    x = [torch.full((2, 3), float(i)) for i in range(4)]
    out = [cc(x[0].numpy())]
    assert fake.log == ["side stream", "fn"]            # call 1: warm-up
    out.append(cc(x[1]))
    assert fake.log[2:] == ["capture", "fn", "replay"]  # call 2
    out.append(cc(x[2]))
    assert fake.log[5:] == ["replay"]                   # later calls
    for xi, oi in zip(x, out):
        assert torch.equal(oi, xi * 2.0 + 1.0)
    # the static output is handed back as a copy: the next replay leaves
    # earlier results alone
    assert out[1].data_ptr() != out[2].data_ptr()
    # a second shape gets an entry (and later a graph) of its own
    cc(torch.zeros(5, 3))
    assert fake.log[6:] == ["side stream", "fn"]
    cc(torch.ones(5, 3))
    assert cc.signatures() == [(((2, 3), torch.float32),),
                               (((5, 3), torch.float32),)]
    assert cc.captured() == 2


def test_failed_capture_raises_and_never_falls_back(monkeypatch):
    fake = _FakeCuda(monkeypatch, fail_capture=True)
    cc = CapturedCall(fake.wrap(lambda x: x + 1.0), "cpu")
    cc.capture = True
    cc(torch.zeros(3))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            cc(torch.zeros(3))
    assert cc.captured() == 0 and "replay" not in fake.log


def test_launched_route_builds_no_entries():
    cc = CapturedCall(lambda x: x + 1.0, "cpu", capture=True)
    assert not cc.capture                # the CPU never captures
    assert torch.equal(cc(np.zeros(2, np.float32)), torch.ones(2))
    assert cc.signatures() == [] and cc.reserved_bytes() == 0


@pytest.mark.parametrize("size", [32, 64])
def test_sweep_is_one_transfer_and_matches_jax(size, monkeypatch):
    rng = np.random.RandomState(size)
    hr = rng.randint(0, 256, (8, size, size, 3)).astype(np.uint8)
    sr = hr.astype(np.int32)
    y = [0] * 4 + [1] * 4
    q = size // 4
    sr[4:, q:3 * q, q:3 * q] = 255 - sr[4:, q:3 * q, q:3 * q]
    sr = np.clip(sr + rng.randint(-20, 21, sr.shape), 0, 255).astype(np.uint8)
    ws_j, auc_j, per_j = jev.sweep_best_window(sr, hr, y)
    with host_traffic(monkeypatch) as seen:
        ws_p, auc_p, per_p = pev.sweep_best_window(sr, hr, y, device="cpu")
    assert seen.count("Tensor.cpu") == 1 and len(per_p) > 1
    assert ws_p == ws_j and auc_p == pytest.approx(auc_j, abs=1e-12)
    assert sorted(per_p) == sorted(per_j)
    for ws in per_j:
        np.testing.assert_allclose(per_p[ws], per_j[ws], atol=1e-5)
