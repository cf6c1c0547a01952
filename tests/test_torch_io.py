"""The port's numpy utilities against the JAX package's, bit for bit:
``data/process_abc.py`` (PCA alignment and its inverse, the h5 writer's
refusal without h5py) and ``utils/io.py`` (ply and xyz files, written byte
for byte alike and read back alike); and the port's ``utils/timing.py`` and
``utils/profiling.py`` on the CPU; the trainers' ``ScalarLogger``: the
port's TensorBoard events against the JAX logger's, and its JSONL record
without them."""

import importlib.util
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gcanet_tpu.data import process_abc as jabc
from gcanet_tpu.train.trainer import ScalarLogger as JScalarLogger
from gcanet_tpu.utils import io as jio
from gcanet_tpu_torch.data import process_abc as tabc
from gcanet_tpu_torch.data.abc_dataset import load_h5_object
from gcanet_tpu_torch.utils import io as tio
from gcanet_tpu_torch.train.trainer import ScalarLogger
from gcanet_tpu_torch.utils import profiling, timing
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize("with_normals", [True, False])
def test_pca_align_restore(with_normals):
    rng = np.random.RandomState(0)
    pts = rng.randn(200, 3) * [3.0, 1.0, 0.2] + [1.0, 2.0, -1.0]
    nrm = rng.randn(200, 3) if with_normals else None
    got, want = tabc.pca_align(pts, nrm), jabc.pca_align(pts, nrm)
    np.testing.assert_array_equal(got[0], want[0])
    if with_normals:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None
    assert got[2].keys() == want[2].keys()
    for key in got[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key])
    restored = tabc.pca_restore(got[0], got[2])
    np.testing.assert_array_equal(restored, jabc.pca_restore(want[0], want[2]))
    np.testing.assert_allclose(restored, pts, atol=1e-5)


def test_pack_h5(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    args = (rng.randn(10, 3), np.arange(10), rng.randn(10, 3), np.ones(10), rng.randn(10, 22))
    path = str(tmp_path / "obj.h5")
    if importlib.util.find_spec("h5py") is not None:
        tabc.pack_h5(path, *args)
        obj = load_h5_object(path)
        for key, value in zip(("points", "labels", "normals", "prim", "T_param"), args):
            want = value.astype(np.int64 if key in ("labels", "prim") else np.float32)
            assert obj[key].dtype == want.dtype
            np.testing.assert_array_equal(obj[key], want)
    monkeypatch.setitem(sys.modules, "h5py", None)      # as if not installed
    with pytest.raises(ImportError, match="needs h5py"):
        tabc.pack_h5(path, *args)


@pytest.mark.parametrize("normal,color", [(False, False), (True, False), (True, True),
                                          (False, True)])
def test_ply_files(tmp_path, normal, color):
    rng = np.random.RandomState(2)
    pts, nrm = rng.randn(30, 3), rng.randn(30, 3)
    rgb = rng.rand(30, 3) if normal else rng.randint(0, 256, (30, 3)).astype(np.uint8)
    kw = dict(normal=nrm if normal else None, color=rgb if color else None)
    got_fn, want_fn = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tio.write_ply(got_fn, pts, **kw)
    jio.write_ply(want_fn, pts, **kw)
    assert open(got_fn, "rb").read() == open(want_fn, "rb").read()
    for g, w in zip(tio.read_ply(got_fn), jio.read_ply(want_fn)):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("normal", [True, False])
def test_xyz_files(tmp_path, normal):
    rng = np.random.RandomState(3)
    pts, nrm = rng.randn(25, 3), rng.randn(25, 3)
    got_fn, want_fn = str(tmp_path / "port.xyz"), str(tmp_path / "jax.xyz")
    tio.write_xyz_files(got_fn, pts, nrm if normal else None)
    jio.write_xyz_files(want_fn, pts, nrm if normal else None)
    assert open(got_fn, "rb").read() == open(want_fn, "rb").read()
    got, want = tio.read_xyz_files(got_fn, normal), jio.read_xyz_files(want_fn, normal)
    for g, w in zip(got if normal else (got,), want if normal else (want,)):
        np.testing.assert_array_equal(g, w)


def test_timing_on_cpu(capsys):
    a = torch.randn(64, 64)
    out = {"x": [a @ a], "y": (a,)}
    assert timing.force_ready(out) is out and timing.cuda_devices(out) == []
    calls = []
    secs = timing.time_fn(lambda m: calls.append(1) or m @ m, a, iters=4, warmup=2)
    assert secs > 0 and len(calls) == 6

    @profiling.timing
    def square(m):
        return m @ m

    torch.testing.assert_close(square(a), a @ a)
    assert "square :" in capsys.readouterr().out
    assert profiling.device_time(out) > 0
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    assert profiling.parameter_count(model) == pytest.approx(26 / 1e6)


def test_profiling_trace_on_cpu(tmp_path):
    a = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)) as prof:
        torch.mm(a, a)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert [p.name for p in tmp_path.iterdir() if p.name.endswith(".pt.trace.json")]


def _events(tb_dir: Path) -> list:
    """(tag, step, value) of every summary value in the TFRecord event files
    under ``tb_dir``: a scalar's value, a histogram's fields.  Read with
    ``tensorboardX``'s protos (``tensorboard`` would import TensorFlow)."""
    from tensorboardX.proto import event_pb2

    out = []
    for path in sorted(tb_dir.glob("events.out.tfevents.*")):
        data = path.read_bytes()
        off = 0
        while off < len(data):
            (length,) = struct.unpack("<Q", data[off:off + 8])
            event = event_pb2.Event.FromString(data[off + 12:off + 12 + length])
            off += 12 + length + 4                  # length, its crc, record, its crc
            for v in event.summary.value:
                h = v.histo
                value = v.simple_value if v.WhichOneof("value") == "simple_value" else (
                    h.min, h.max, h.num, h.sum, h.sum_squares, tuple(h.bucket_limit),
                    tuple(h.bucket))
                out.append((v.tag, event.step, value))
    return out


def _feed(logger) -> None:
    logger.log_scalars({"loss": 1.25, "lr": 1e-3}, 0)
    logger.log_scalars({"loss": 0.75, "miou": 0.5}, 10)
    logger.log_histogram("weights", np.random.default_rng(0).standard_normal(200), 10)


def test_scalar_logger_events_match_jax(tmp_path):
    port = ScalarLogger(str(tmp_path / "port"), "train")
    jax_logger = JScalarLogger(str(tmp_path / "jax"), "train")
    for logger in (port, jax_logger):
        _feed(logger)
    port.close()
    jax_logger.tb.close()
    got, want = (_events(tmp_path / side / "tb" / "train") for side in ("port", "jax"))
    assert [(t, s) for t, s, _ in got] == [("loss", 0), ("lr", 0), ("loss", 10), ("miou", 10),
                                          ("weights", 10)]
    assert got == want
    records = [json.loads(line) for line in (tmp_path / "port" / "scalars_train.jsonl")
               .read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 10, 10] and records[2]["histogram"] == "weights"


def test_scalar_logger_jsonl_without_events(tmp_path, monkeypatch):
    off = ScalarLogger(str(tmp_path / "off"), "test", tensorboard=False)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)       # not importable
    hidden = ScalarLogger(str(tmp_path / "hidden"), "test")
    for side, logger in (("off", off), ("hidden", hidden)):
        assert logger.tb is None
        _feed(logger)
        logger.close()
        assert not (tmp_path / side / "tb").exists()
        lines = (tmp_path / side / "scalars_test.jsonl").read_text().splitlines()
        assert [json.loads(line)["step"] for line in lines] == [0, 10, 10]
