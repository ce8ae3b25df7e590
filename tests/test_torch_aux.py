"""The port's copies of the runner's auxiliary paths against the JAX package
on the CPU, each byte-equal to the JAX runner on the smallest golden
scenario (somatic_snv, seed 0):

- `--trace-file`: the VCF, the stderr summary and the trace's windows and
  read counts (its per-window milliseconds are wall times);
- `--rg-file`: an allowlist naming another group (every read dropped),
  naming the reads' group, and empty (the "null" sentinel keeps all);
- resume over a torn log tail: the first run's checkpoint log, then a run
  over that log with a torn record appended;
- `--bed` regions (two BED rows, padded twice as the reference does);
- the `print_pairs` export of a window's graph.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from goldengen import scenario  # noqa: E402
from helpers import write_pair  # noqa: E402

from lancet_tpu.config import Config as JaxConfig  # noqa: E402
from lancet_tpu.config import Filters as JaxFilters  # noqa: E402
from lancet_tpu.runner import run as jax_run  # noqa: E402
from lancet_tpu_torch import runner as torch_runner  # noqa: E402
from lancet_tpu_torch.config import Config  # noqa: E402

# One intra-op thread: the test workers share the host's cores, and
# PyTorch's OpenMP threads, spinning while oversubscribed, slow every
# worker down many times over.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scen(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aux"))
    refseq, tumor, normal, region = scenario("somatic_snv", 0)
    write_pair(d, refseq, "chr1", tumor, normal)
    return d, region


def _cfg(scen, **kw) -> dict:
    d, region = scen
    kw.setdefault("region", region)
    return dataclasses.asdict(JaxConfig(
        tumor_bam=f"{d}/tumor.bam", normal_bam=f"{d}/normal.bam",
        ref_fasta=f"{d}/ref.fa", **kw))


def _captured(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        vcf = fn()
    return vcf, err.getvalue()


def _port(d: dict):
    return _captured(lambda: torch_runner.run(
        Config.from_dict(d), command_line="t", date="D\n", device="cpu"))


def _jax(d: dict):
    cfg = JaxConfig(**dict(d, filters=JaxFilters(**d["filters"])))
    return _captured(lambda: jax_run(cfg, command_line="t", date="D\n",
                                     engine="tpu"))


def _records(vcf):
    return [ln for ln in vcf.splitlines() if ln and ln[0] != "#"]


def test_trace_file_equals_jax(scen, tmp_path):
    traces = {}
    outs = {}
    for name, fn in (("port", _port), ("jax", _jax)):
        tf = str(tmp_path / f"{name}.jsonl")
        outs[name] = fn(_cfg(scen, trace_file=tf))
        with open(tf) as f:
            traces[name] = [json.loads(ln) for ln in f]
    assert outs["port"] == outs["jax"]
    assert _records(outs["port"][0])
    for name, recs in traces.items():
        assert recs and all(set(r) == {"window", "ms", "reads"}
                            and r["ms"] >= 0 for r in recs), name
    assert ([(r["window"], r["reads"]) for r in traces["port"]]
            == [(r["window"], r["reads"]) for r in traces["jax"]])
    assert any(r["reads"] > 0 for r in traces["port"])


@pytest.mark.parametrize("groups", ["someothergroup\n", "rg1\n", ""])
def test_rg_file_equals_jax(scen, tmp_path, groups):
    rgf = tmp_path / "rg.txt"
    rgf.write_text(groups)
    d = _cfg(scen, rg_file=str(rgf))
    port = _port(d)
    assert port == _jax(d)
    # every read carries the group rg1 (tests/helpers.py write_bam)
    if groups == "someothergroup\n":
        assert not _records(port[0])
    else:
        assert port == _port(_cfg(scen))


def test_resume_over_torn_tail_equals_jax(scen, tmp_path):
    logs = {}
    for name, fn in (("port", _port), ("jax", _jax)):
        rdir = str(tmp_path / name)
        d = _cfg(scen, resume_dir=rdir)
        fresh = fn(d)
        assert fresh[0] == fn(_cfg(scen))[0]
        files = sorted(os.listdir(rdir))
        assert files, name
        logs[name] = {f: open(os.path.join(rdir, f)).read() for f in files}
        with open(os.path.join(rdir, files[0]), "a") as f:
            f.write('{"windows": ["chr1:1-600"], "vari')  # a torn write
        logs[name + "_resumed"] = fn(d)
        assert logs[name + "_resumed"][0] == fresh[0], name
        logs[name + "_fresh"] = fresh
    assert logs["port"] == logs["jax"]
    assert logs["port_fresh"] == logs["jax_fresh"]
    assert logs["port_resumed"] == logs["jax_resumed"]


def test_bed_regions_equal_jax(scen, tmp_path):
    bed = tmp_path / "regions.bed"
    # a comment, a short row (skipped) and two regions around the SNV
    bed.write_text("# regions\nchr1\t900\nchr1\t940\t990\tsnv\n"
                   "chr1\t1010\t1060\n")
    d = _cfg(scen, bed_file=str(bed), region="")
    port = _port(d)
    assert port == _jax(d)
    assert _records(port[0])


def _first_pairs(pkg: str, cfg_d: dict, out: str) -> str:
    """print_pairs of the first graph the per-window engine of `pkg`
    compresses, as text."""
    import importlib

    dot = importlib.import_module(f"{pkg}.engine.dot")
    graph = importlib.import_module(f"{pkg}.engine.graph")
    micro = importlib.import_module(f"{pkg}.engine.micro")
    pio = importlib.import_module(f"{pkg}.io")
    windows_mod = importlib.import_module(f"{pkg}.windows")
    if pkg == "lancet_tpu":
        cfg = JaxConfig(**dict(cfg_d, filters=JaxFilters(**cfg_d["filters"])))
        kw = {}
    else:
        cfg = Config.from_dict(cfg_d)
        kw = {"device": "cpu"}
    captured = []
    orig = graph.Graph.compress

    def spy(self, compid):
        if not captured:
            dot.print_pairs(self, out)
            captured.append(out)
        return orig(self, compid)

    graph.Graph.compress = spy
    try:
        fa = pio.open_fasta(cfg.ref_fasta)
        wins = windows_mod.generate_windows(fa, [cfg.region], fa.lengths,
                                            cfg.window_size, cfg.padding)
        ma = micro.Microassembler(cfg, readers=(pio.open_bam(cfg.tumor_bam),
                                                pio.open_bam(cfg.normal_bam)),
                                  **kw)
        with contextlib.redirect_stderr(io.StringIO()):
            for w in wins:
                ma.process_window(w)
    finally:
        graph.Graph.compress = orig
    assert captured, pkg
    with open(out) as f:
        return f.read()


def test_print_pairs_equals_jax(scen, tmp_path):
    d = _cfg(scen)
    port = _first_pairs("lancet_tpu_torch", d, str(tmp_path / "port.fa"))
    jax = _first_pairs("lancet_tpu", d, str(tmp_path / "jax.fa"))
    assert port == jax
    heads = [ln for ln in port.splitlines() if ln.startswith(">")]
    assert heads and any(ln.count(":") >= 3 for ln in heads)
