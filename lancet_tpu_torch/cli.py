"""Command-line interface, flag-compatible with reference lancet
(ref: src/Lancet.cc:645-790 long options)."""

from __future__ import annotations

import argparse
import sys

from .config import Config, Filters
from .runner import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lancet-tpu",
        description="Somatic micro-assembly variant caller (PyTorch/CUDA)")
    p.add_argument("--tumor", "-t", required=True)
    p.add_argument("--normal", "-n", required=True)
    p.add_argument("--ref", "-r", required=True)
    p.add_argument("--reg", "-p", default="")
    p.add_argument("--bed", "-B", default="")
    p.add_argument("--rg-file", "-g", default="",
                   help="read-group allowlist file (one RG per line)")
    p.add_argument("--min-k", "-k", type=int, default=11)
    p.add_argument("--max-k", "-K", type=int, default=101)
    p.add_argument("--trim-lowqual", "-q", type=int, default=10)
    p.add_argument("--min-base-qual", "-C", type=int, default=17)
    p.add_argument("--quality-range", "-Q", default="!")
    p.add_argument("--min-map-qual", "-b", type=int, default=15)
    p.add_argument("--max-as-xs-diff", "-Z", type=int, default=5)
    p.add_argument("--tip-len", "-l", type=int, default=11)
    p.add_argument("--cov-thr", "-c", type=int, default=5)
    p.add_argument("--cov-ratio", "-x", type=float, default=0.01)
    p.add_argument("--low-cov", "-d", type=int, default=1)
    p.add_argument("--max-avg-cov", "-u", type=int, default=10000)
    p.add_argument("--window-size", "-w", type=int, default=600)
    p.add_argument("--padding", "-P", type=int, default=250)
    p.add_argument("--dfs-limit", "-F", type=int, default=1000000)
    p.add_argument("--max-indel-len", "-T", type=int, default=500)
    p.add_argument("--max-mismatch", "-M", type=int, default=2)
    p.add_argument("--num-threads", "-X", type=int, default=1)
    p.add_argument("--node-str-len", "-L", type=int, default=100)
    # filters
    p.add_argument("--min-alt-count-tumor", "-a", type=int, default=3)
    p.add_argument("--max-alt-count-normal", "-m", type=int, default=0)
    p.add_argument("--min-vaf-tumor", "-e", type=float, default=0.04)
    p.add_argument("--max-vaf-normal", "-i", type=float, default=0.0)
    p.add_argument("--min-coverage-tumor", "-o", type=int, default=4)
    p.add_argument("--max-coverage-tumor", "-y", type=int, default=1000000)
    p.add_argument("--min-coverage-normal", "-z", type=int, default=10)
    p.add_argument("--max-coverage-normal", "-j", type=int, default=1000000)
    p.add_argument("--min-phred-fisher", "-s", type=float, default=5.0)
    p.add_argument("--min-phred-fisher-str", "-E", type=float, default=25.0)
    p.add_argument("--min-strand-bias", "-f", type=int, default=1)
    # STR
    p.add_argument("--max-unit-length", "-U", type=int, default=4)
    p.add_argument("--min-report-unit", "-N", type=int, default=3)
    p.add_argument("--min-report-len", "-Y", type=int, default=7)
    p.add_argument("--dist-from-str", "-D", type=int, default=1)
    # flags
    p.add_argument("--linked-reads", "-J", action="store_true")
    p.add_argument("--primary-alignment-only", "-I", action="store_true")
    p.add_argument("--XA-tag-filter", "-O", dest="xa_filter", action="store_true")
    p.add_argument("--active-region-off", "-W", action="store_true")
    p.add_argument("--kmer-recovery", "--kmer-recovery-on", "-R",
                   action="store_true")
    p.add_argument("--print-graph", "-A", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--more-verbose", "-V", action="store_true")
    p.add_argument("--print-config-file", "-G", action="store_true",
                   help="dump the effective configuration to config.txt")
    # new-framework options
    p.add_argument("--engine", choices=["oracle", "batched"],
                   default="batched",
                   help="execution engine (batched = device kernels; "
                        "oracle = host only)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the batched engine's kernels")
    p.add_argument("--out", default="-", help="output VCF path (default stdout)")
    p.add_argument("--trace-file", default="",
                   help="per-window wall-time JSONL (profiling)")
    p.add_argument("--resume-dir", default="",
                   help="checkpoint dir: append completed-window logs and "
                        "resume an interrupted run from them")
    p.add_argument("--processes", action="store_true",
                   help="fan shards out to a host process pool")
    return p


def config_from_args(a) -> Config:
    filters = Filters(
        min_phred_fisher_str=a.min_phred_fisher_str,
        min_phred_fisher=a.min_phred_fisher,
        max_vaf_normal=a.max_vaf_normal,
        min_vaf_tumor=a.min_vaf_tumor,
        min_cov_normal=a.min_coverage_normal,
        max_cov_normal=a.max_coverage_normal,
        min_cov_tumor=a.min_coverage_tumor,
        max_cov_tumor=a.max_coverage_tumor,
        min_alt_cnt_tumor=a.min_alt_count_tumor,
        max_alt_cnt_normal=a.max_alt_count_normal,
        min_strand_bias=a.min_strand_bias)
    return Config(
        tumor_bam=a.tumor, normal_bam=a.normal, ref_fasta=a.ref,
        region=a.reg, bed_file=a.bed, min_k=a.min_k, max_k=a.max_k,
        max_tip_len=a.tip_len, cov_threshold=a.cov_thr,
        min_cov_ratio=a.cov_ratio, low_cov_threshold=a.low_cov,
        max_avg_cov=a.max_avg_cov, dfs_limit=a.dfs_limit,
        max_indel_len=a.max_indel_len, max_mismatch=a.max_mismatch,
        window_size=a.window_size, padding=a.padding,
        min_qv_trim=a.trim_lowqual, min_qv_call=a.min_base_qual,
        qv_range=ord(a.quality_range[0]), min_map_qual=a.min_map_qual,
        max_delta_as_xs=a.max_as_xs_diff, max_unit_len=a.max_unit_length,
        min_report_units=a.min_report_unit, min_report_len=a.min_report_len,
        dist_from_str=a.dist_from_str, lr_mode=a.linked_reads,
        xa_filter=a.xa_filter,
        primary_alignment_only=a.primary_alignment_only,
        active_regions=not a.active_region_off,
        kmer_recovery=a.kmer_recovery, verbose=a.verbose,
        very_verbose=a.more_verbose, print_graph=a.print_graph,
        print_config_file=a.print_config_file, rg_file=a.rg_file,
        trace_file=a.trace_file, resume_dir=a.resume_dir,
        num_threads=a.num_threads,
        node_strlen=a.node_str_len, filters=filters)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.reg and not args.bed:
        print("ERROR: Must provide region (-p) or BED file (-B)",
              file=sys.stderr)
        return 1
    cfg = config_from_args(args)
    vcf = run(cfg, command_line=" ".join(sys.argv), engine=args.engine,
              device=args.device, processes=args.processes)
    if args.out == "-":
        sys.stdout.write(vcf)
    else:
        with open(args.out, "w") as f:
            f.write(vcf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
