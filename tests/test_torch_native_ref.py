"""The JAX reference's native library, and one built for the test host.

`wrenc_tpu/entropy/native/libwrenc_native.so` is a checked-in binary built
with `-march=native` on a CPU with AVX512-FP16. A fresh checkout gives it
the same mtime as its source, so the JAX loader loads it instead of
rebuilding it, and on a CPU without those instructions the JAX native
commit, chroma stage A, slice coder and decoder die of SIGILL.

* The port's byte tests run the JAX search as their reference, so they
  take the autouse fixture `jax_native_host_build` (import it into the
  module): for the length of each test it points the JAX loader at a build
  of the JAX package's own `wrenc_native.cpp`, with that loader's g++
  flags, made for this CPU in the port's ignored `_build/` directory, and
  restores the loader's previous state afterwards.
* The JAX package's own tests keep the tracked library wherever it runs.
  When this module is imported, a subprocess encodes and decodes one small
  frame through the JAX search with the tracked library. Only when that
  process is killed by a signal does the rest of the session use the host
  build, with a warning in pytest's summary: otherwise each crash takes an
  xdist worker down, and past xdist's restart limit the run stops.
  pytest imports every test module before it runs a test, so in a whole
  run this covers every module; a JAX test file run alone on such a host
  still crashes (ROADMAP, test-host hazard).

No file of the JAX package changes. A failed build, or a probe that fails
without a signal, raises.
"""
import contextlib
import fcntl
import hashlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.entropy.native import loader as jloader
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.spec import quant, transform

from wrenc_tpu_torch.entropy.native import loader as tloader
from wrenc_tpu_torch.kernels import np_ops

REF_SO = os.path.join(tloader._BUILD, "libwrenc_native_ref.so")
TRACKED_SO = os.path.join(os.path.dirname(jloader._SRC), "libwrenc_native.so")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.decoder import decode_annexb
from wrenc_tpu.encoder import Encoder
from wrenc_tpu.search import WavefrontSearch
from tests.test_entropy_roundtrip import synth_frame
cfg = EncoderConfig(width=64, height=64, qp=32)
stream, recons = Encoder(cfg, search=WavefrontSearch(cfg)).encode(
    [synth_frame(64, 64, seed=1)])
assert all((d == r).all() for d, r in zip(decode_annexb(stream)[0],
                                           recons[0]))
"""


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def tracked_library_runs():
    """Whether the tracked JAX library survives a small encode and decode
    on this CPU. The verdict is kept in `_build/`, keyed by the library's
    bytes and the CPU's flags, so one process of a session probes."""
    with open(TRACKED_SO, "rb") as f:
        key = hashlib.sha256(f.read() + _cpu_flags().encode()).hexdigest()
    path = os.path.join(tloader._BUILD, f"jax_native_probe.{key[:16]}")
    os.makedirs(tloader._BUILD, exist_ok=True)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(path):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join(
                           [ROOT, os.environ.get("PYTHONPATH", "")]))
            proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                                  env=env, capture_output=True, text=True)
            if proc.returncode > 0:
                raise RuntimeError("JAX native probe failed:\n"
                                   + proc.stderr[-4000:])
            with open(path, "w") as f:
                f.write("runs" if proc.returncode == 0
                        else f"signal {-proc.returncode}")
        with open(path) as f:
            return f.read() == "runs"


def _point_jax_loader_at(so):
    with jloader._lock:
        saved = jloader._SO, jloader._lib, jloader._failed
        jloader._SO, jloader._lib, jloader._failed = so, None, False
    return saved


# pytest imports this file as `test_torch_native_ref`, the port's byte
# tests as `tests.test_torch_native_ref`: the second import finds the
# session already switched
if jloader._SO == TRACKED_SO and not tracked_library_runs():
    tloader.build_library(jloader._SRC, REF_SO)
    _point_jax_loader_at(REF_SO)
    warnings.warn(
        f"{os.path.relpath(TRACKED_SO, ROOT)} dies of a signal on this "
        f"CPU; this session's JAX native calls use "
        f"{os.path.relpath(REF_SO, ROOT)}, built here "
        "from the JAX package's wrenc_native.cpp (ROADMAP, test-host "
        "hazard)")


@contextlib.contextmanager
def host_jax_native():
    """Within: the JAX loader loads REF_SO, built here from its source."""
    tloader.build_library(jloader._SRC, REF_SO)
    saved = _point_jax_loader_at(REF_SO)
    try:
        yield
    finally:
        with jloader._lock:
            jloader._SO, jloader._lib, jloader._failed = saved


@pytest.fixture(autouse=True)
def jax_native_host_build():
    with host_jax_native():
        yield


def test_host_build_is_scoped_to_the_test():
    assert jloader._SO == REF_SO and jloader.available()
    assert os.path.getmtime(REF_SO) >= os.path.getmtime(jloader._SRC)
    lib = jloader._lib
    with host_jax_native():
        assert jloader._SO == REF_SO and jloader._lib is None
        assert jloader.available()
    assert jloader._SO == REF_SO and jloader._lib is lib


def _blocks(seed, log2):
    rng = np.random.default_rng(seed)
    n = 1 << log2
    res = rng.integers(-150, 151, size=(6, n, n)).astype(np.int32)
    return np.stack([transform.forward(r) for r in res])


@pytest.mark.parametrize("trellis", [True, False],
                         ids=["trellis", "greedy"])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_port_native_quant_matches_reference(log2, trellis):
    """The port's native quantizers == its numpy copies == the JAX
    package's native library."""
    qp = 30 if trellis else 34
    t = _blocks(100 + 10 * log2 + trellis, log2)
    qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                     transform_skip=False)
    lam = np.asarray(jkq.lam_dq_table(RateModelConfig(), qp, trellis))
    name = "trellis_quant_native" if trellis else "greedy_quant_native"
    q = getattr(tloader, name)(t, qpar.ls, qpar.bd_shift, lam, log2)
    q_np = (np_ops.trellis_depquant_np if trellis
            else np_ops.greedy_depquant_np)(t, qpar.ls, qpar.bd_shift, lam,
                                            log2)
    q_ref = getattr(jloader, name)(t, qpar.ls, qpar.bd_shift, lam, log2)
    assert q.dtype == np.int16 and q.shape == t.shape
    assert np.abs(q).sum() > 0
    assert (q == q_np).all()
    assert (q == q_ref).all()
