"""The port's device graph engine (LANCET_TPU_DEVGRAPH=1) end to end on the
CPU, against the JAX package.

`lancet_tpu_torch.runner.run(..., device="cpu")` with LANCET_TPU_DEVGRAPH=1
must give a VCF and a stderr summary byte-equal to
`lancet_tpu.runner.run(engine="tpu")` with the variable unset (the JAX
package's native plane, which its own tests hold equal to its device
graph engine): on the five golden scenarios, on adversarial windows (STR
runs, near-repeat duplications, homopolymers, dense het SNVs, internal
tandem duplications) and with the first shape bucket shrunk so that
windows are promoted. An error inside
the device engine propagates out of runner.run. (The port's PathJobs and
device-graph stats against the JAX device engine's own are held in
tests/test_torch_graphwalks.py.)
"""

import contextlib
import io
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from goldengen import scenario  # noqa: E402
from helpers import write_pair  # noqa: E402

from lancet_tpu.config import Config as JaxConfig  # noqa: E402
from lancet_tpu.runner import run as jax_run  # noqa: E402
from lancet_tpu_torch import corpus  # noqa: E402
from lancet_tpu_torch import runner as torch_runner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402
from lancet_tpu_torch.engine import devicepipe  # noqa: E402
from lancet_tpu_torch.gpu import walks  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = fn()
    return vcf, err.getvalue()


def _both(tmp_path, monkeypatch, refseq, tumor, normal, region, **kw):
    """(port devgraph (VCF, stderr), JAX native (VCF, stderr), port
    stats)."""
    ref, t, n = write_pair(str(tmp_path), refseq, "chr1", tumor, normal)
    d = dict(tumor_bam=t, normal_bam=n, ref_fasta=ref, region=region, **kw)
    monkeypatch.delenv("LANCET_TPU_DEVGRAPH", raising=False)
    want = _captured(lambda: jax_run(JaxConfig(**d), command_line="t",
                                     date="D\n", engine="tpu"))
    monkeypatch.setenv("LANCET_TPU_DEVGRAPH", "1")
    stats: dict = {}
    got = _captured(lambda: torch_runner.run(
        Config(**d), command_line="t", date="D\n", device="cpu",
        stats=stats))
    return got, want, stats


@pytest.mark.parametrize("name", [
    "somatic_snv", "somatic_del", "str_indel", "paired_overlap",
    "adjacent_complex",
])
def test_devgraph_matches_jax_native(tmp_path, monkeypatch, name):
    got, want, stats = _both(tmp_path, monkeypatch, *scenario(name, 1))
    assert got == want
    assert stats["n_dev_windows"] > 0
    if name == "paired_overlap":
        # mate-overlap candidates route through the native replay
        assert stats["dev_fallback_causes"].get("mate_overlap", 0) > 0
    else:
        assert stats["n_dev_fallback"] == 0 and stats["k_histogram"]


def test_devgraph_adversarial_windows(tmp_path, monkeypatch):
    """corpus.adversarial_corpus: tests/test_devgraph.py's adversarial
    windows and two internal tandem duplications, whose cycles reach the
    exact cycle replay."""
    real = walks.cycle_dfs
    replayed = []

    def counted(adj, e_dst, e_dir, alive, special, N, Cmax, lane_mask):
        src = alive[:, N + 2 * torch.arange(Cmax)]
        replayed.append(int((lane_mask & src).sum()))
        return real(adj, e_dst, e_dir, alive, special, N, Cmax, lane_mask)

    monkeypatch.setattr(walks, "cycle_dfs", counted)
    got, want, stats = _both(tmp_path, monkeypatch,
                             *corpus.adversarial_corpus(), num_threads=2)
    assert got == want
    assert stats["n_dev_windows"] > 0
    # the adversarial families push the k ladder
    assert any(int(k) > 11 for k in stats["k_histogram"])
    assert sum(replayed) > 0


def test_devgraph_bucket_promotion(tmp_path, monkeypatch):
    """With the first bucket's node/edge caps shrunk below any real
    window, windows are promoted to the next bucket at the same k (no
    shape_caps fallback) and the VCF still equals the JAX package's."""
    monkeypatch.setattr(devicepipe, "_BUCKETS",
                        ((48, 160, 64, 160),) + devicepipe._BUCKETS[1:])
    got, want, stats = _both(tmp_path, monkeypatch,
                             *scenario("somatic_snv", 1))
    assert got == want
    assert stats["dev_fallback_causes"].get("shape_caps", 0) == 0
    assert stats["n_dev_windows"] > 0 and stats["n_dev_fallback"] == 0


def test_devgraph_error_propagates(tmp_path, monkeypatch):
    """No fallback hides the device: an exception inside run_device_graph
    comes out of runner.run."""
    refseq, tumor, normal, region = scenario("somatic_snv", 1)
    ref, t, n = write_pair(str(tmp_path), refseq, "chr1", tumor, normal)

    def boom(*a, **k):
        raise RuntimeError("device engine failed")

    monkeypatch.setattr(devicepipe, "run_device_graph", boom)
    monkeypatch.setenv("LANCET_TPU_DEVGRAPH", "1")
    cfg = Config(tumor_bam=t, normal_bam=n, ref_fasta=ref, region=region)
    with pytest.raises(RuntimeError, match="device engine failed"):
        torch_runner.run(cfg, command_line="t", date="D\n", device="cpu")
