"""The port stands alone: it imports neither JAX nor the JAX package, its
defaults and constants equal the JAX package's, and it never falls back
quietly to the CPU."""

import dataclasses
import inspect
import os
import random
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from goldengen import hap_reads as jax_hap_reads  # noqa: E402

import lancet_tpu.config as jcfg  # noqa: E402
import lancet_tpu.engine.devicepipe as jdevpipe  # noqa: E402
import lancet_tpu.tpu.dbg as jdbg  # noqa: E402
import lancet_tpu.tpu.pipeline as jpipeline  # noqa: E402
import lancet_tpu.engine.align as jalign  # noqa: E402
import lancet_tpu.runner as jrunner  # noqa: E402
import lancet_tpu_torch.config as tcfg  # noqa: E402
import lancet_tpu_torch.engine.align as talign  # noqa: E402
import lancet_tpu_torch.engine.devicepipe as tdevpipe  # noqa: E402
import lancet_tpu_torch.gpu.pack as tpack  # noqa: E402
import lancet_tpu_torch.gpu.pipeline as tpipeline  # noqa: E402
from lancet_tpu_torch import corpus  # noqa: E402
from lancet_tpu_torch import runner as trunner  # noqa: E402
from lancet_tpu_torch.gpu.align_batch import batch_align  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, pkgutil, sys
import lancet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(lancet_tpu_torch.__path__,
                                              "lancet_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"lancet_tpu_torch.parallel.mesh",
        "lancet_tpu_torch.parallel.multihost"} <= set(mods), mods
from lancet_tpu_torch import corpus
from lancet_tpu_torch.config import Config
from lancet_tpu_torch.parallel.mesh import make_mesh
from lancet_tpu_torch.runner import run
d = sys.argv[1]
ref = corpus.make_reference(1400, seed=11)
alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref[700]]
t = corpus.hap_reads(ref, ("s", 700, alt), 450, 950, 100, 5, "t", 0.5, 1)
n = corpus.hap_reads(ref, None, 450, 950, 100, 5, "n", 0, 2)
r, tb, nb = corpus.write_pair(d, ref, "chr1", t, n)
cfg = Config(tumor_bam=tb, normal_bam=nb, ref_fasta=r, region="chr1:650-750")
vcf = run(cfg, date="D\n", device="cpu")
assert any(ln and ln[0] != "#" for ln in vcf.splitlines()), vcf
assert run(cfg, date="D\n", device="cpu",
           mesh=make_mesh(devices=["cpu"] * 2)) == vcf
bad = sorted(k for k in sys.modules
             if k in ("jax", "lancet_tpu") or k.startswith(("jax.",
                                                             "lancet_tpu.")))
print(len(mods), bad)
assert not bad, bad
"""


def test_port_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    n_mods, bad = r.stdout.split(maxsplit=1)
    assert int(n_mods) >= 20 and bad.strip() == "[]"


def test_defaults_and_constants_equal_jax():
    assert (dataclasses.asdict(tcfg.Config())
            == dataclasses.asdict(jcfg.Config()))
    assert (dataclasses.asdict(tcfg.Filters())
            == dataclasses.asdict(jcfg.Filters()))
    for name in ("MATCH", "MISMATCH", "GAP_OPEN", "GAP_EXTEND"):
        assert getattr(talign, name) == getattr(jalign, name)
    assert (talign.STAR, talign.DIAG, talign.LEFT, talign.UP) == (
        jalign._STAR, jalign._DIAG, jalign._LEFT, jalign._UP)
    assert trunner.LANCET_VERSION == jrunner.LANCET_VERSION
    # the device graph engine's shapes and caps, so that job lists compare
    # one for one
    for name in ("_BUCKETS", "_TIERS", "_CMAX", "_D"):
        assert getattr(tdevpipe, name) == getattr(jdevpipe, name), name
    assert (inspect.signature(tdevpipe.run_device_graph).parameters[
        "Lraw"].default == inspect.signature(
            jdevpipe.run_device_graph).parameters["Lraw"].default == 1152)
    assert tdevpipe.W_DEFAULT == 32  # the JAX engine's W (devicepipe.py:167)
    for name in ("NCR_DEFAULT", "ECR_DEFAULT", "_SL_CAP", "_SL_ITEMS"):
        assert getattr(tpipeline, name) == getattr(jpipeline, name), name
    for name in ("S_TMR", "S_NML", "S_REF"):
        assert getattr(tpack, name) == getattr(jdbg, name), name
    cfg = jcfg.Config(region="chr1:1-9", num_threads=3, lr_mode=True,
                      filters=jcfg.Filters(min_vaf_tumor=0.1))
    port = tcfg.Config.from_dict(dataclasses.asdict(cfg))
    assert isinstance(port.filters, tcfg.Filters)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert tcfg.print_configuration(port) == jcfg.print_configuration(cfg)


def test_corpus_generator_equals_tests_generator():
    ref = corpus.make_reference(3000, seed=4)
    rng = random.Random(1)
    for edit in (("s", 1500, "A" if ref[1500] != "A" else "C"),
                 ("i", 1500, "GAT"), ("d", 1500, 4), None):
        seed = rng.randrange(1000)
        got = corpus.hap_reads(ref, edit, 1000, 2000, 100, 5, "t", 0.5, seed)
        want = jax_hap_reads(ref, edit, 1000, 2000, 100, 5, "t", 0.5, seed)
        assert ([dataclasses.astuple(a) for a in got]
                == [dataclasses.astuple(a) for a in want])


def test_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfg.Config(tumor_bam=f"{tmp_path}/t.bam",
                      normal_bam=f"{tmp_path}/n.bam",
                      ref_fasta=f"{tmp_path}/r.fa", region="chr1:1-9")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.run(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_align([("ACGT", "ACT")])


def test_mesh_raises_without_card():
    """A mesh of cards needs a card: make_mesh() and make_local_mesh() do
    not fall back to the host; a mesh on the host is asked for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lancet_tpu_torch.parallel.mesh import make_local_mesh, make_mesh

    for fn in (make_mesh, make_local_mesh, lambda: make_mesh(1),
               lambda: make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert make_mesh(devices=["cpu"] * 3) == (torch.device("cpu"),) * 3


@pytest.mark.parametrize("mode", ["processes", "kmer_recovery",
                                  "print_graph"])
def test_unported_modes_raise(mode, tmp_path, monkeypatch):
    """The modes the first slice left out (they raised then) run now, on
    the port's own per-window engine."""
    ref = corpus.make_reference(1400, seed=11)
    alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[ref[700]]
    t = corpus.hap_reads(ref, ("s", 700, alt), 450, 950, 100, 5, "t", 0.5, 1)
    n = corpus.hap_reads(ref, None, 450, 950, 100, 5, "n", 0, 2)
    r, tb, nb = corpus.write_pair(str(tmp_path), ref, "chr1", t, n)
    kw = ({"num_threads": 2} if mode == "processes" else {mode: True})
    cfg = tcfg.Config(tumor_bam=tb, normal_bam=nb, ref_fasta=r,
                      region="chr1:650-750", **kw)
    monkeypatch.setenv("LANCET_TPU_NO_SHARDRUN", "1")
    monkeypatch.chdir(tmp_path)
    stats: dict = {}
    vcf = trunner.run(cfg, processes=mode == "processes", device="cpu",
                      stats=stats)
    assert any(ln and ln[0] != "#" for ln in vcf.splitlines())
    assert ("t_gates" in stats) == (mode == "processes")
    if mode == "print_graph":
        assert any(f.endswith(".dot") for f in os.listdir(tmp_path))
