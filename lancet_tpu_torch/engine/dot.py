"""Graph debug exports: DOT / FASTA / stats (ref: Graph.cc:1661-2022,
3662-3691; file naming per stage as in README.md:110-146).

Enabled by --print-graph; written after every assembly stage with the
reference's naming: <window>.0.dot, .1l.c<N>.dot (anchored), .2c (compressed),
.3l (low-cov removed), .4t (tips removed), .5s (short links removed),
.final.c<N>.dot.
"""

from __future__ import annotations

COLOR_ALL = "white"
COLOR_LOW = "grey"
COLOR_NOVO = "darkorange3"
COLOR_TUMOR = "red"
COLOR_NORMAL = "green"
COLOR_SHARED = "blue"
COLOR_SOURCE = 'orange" style="filled'
COLOR_SINK = 'yellow" style="filled'
COLOR_TOUCH = "magenta"


def _node_color(g, node) -> str:
    if node.is_source:
        return COLOR_SOURCE
    if node.is_sink:
        return COLOR_SINK
    if node.touch_ref:
        return COLOR_TOUCH
    avgcov = g.totalreadbp / len(g.ref.rawseq) if g.ref and g.ref.rawseq else 0
    color = COLOR_ALL
    if node.mincov <= g.LOW_COV_THRESHOLD or node.mincov <= g.MIN_COV_RATIO * avgcov:
        return COLOR_LOW
    if node.is_tumor and not node.is_normal:
        return COLOR_TUMOR
    if node.is_normal and not node.is_tumor:
        return COLOR_NORMAL
    if node.is_tumor and node.is_normal:
        return COLOR_SHARED
    return color


def _edge_color(g, cur, e) -> str:
    c1 = _node_color(g, cur)
    other = g.get_edge_node(e)
    c2 = _node_color(g, other) if other is not None else COLOR_ALL
    if c1 == COLOR_LOW or c2 == COLOR_LOW:
        return COLOR_LOW
    if c1 == COLOR_NOVO and c2 == COLOR_NOVO:
        return COLOR_NOVO
    return COLOR_ALL


def print_dot(g, filename: str, compid: int, node_strlen: int = 100,
              print_reads: bool = True) -> None:
    with open(filename, "w") as fp:
        if print_reads:
            for i, info in enumerate(g.readid2info):
                fp.write(f"// {info.set_name} {i} {info.readname} -> "
                         f"{info.mateid} ()\n")
            fp.write("\n\n")
        fp.write("digraph structs{\n")
        fp.write('  graph [bgcolor=black,size="80,110",layout=neato,'
                 "ratio=compress,rankdir=LR]\n")
        fp.write("  node [shape=circle,style=filled,fontsize=1,"
                 "fixedsize=true,hight=1,width=1];\n")
        fp.write("  edge [fixedsize=true,len=1.2];\n")
        nodes = 0
        for cur in g.node_iter():
            if cur.component != compid:
                continue
            nodes += 1
            color = _node_color(g, cur)
            shape = "diamond" if (cur.is_source or cur.is_sink) else "circle"
            label_seq = cur.str_m[:node_strlen]
            ell = "..." if cur.strlen() > node_strlen else ""
            fp.write(
                f'  {cur.nodeid} [label="{nodes}:{cur.nodeid} | <F> '
                f'{label_seq}{ell} | <R> len={cur.strlen()} '
                f'cov={cur.tot_cov():.2f} rd:{len(cur.reads)} B:0 " '
                f'color="{color}" shape="{shape}"]\n')
            for e in cur.edges:
                if e.dir != "RR" and (e.dir == "FF" or cur.nodeid <= e.nodeid):
                    ecolor = _edge_color(g, cur, e)
                    fp.write(
                        f'    {cur.nodeid}:{e.startdir()} -> '
                        f'{e.nodeid}:{e.destdir()} [arrowhead="normal" '
                        f'arrowtail="normal" color="{ecolor}"]\n')
                else:
                    fp.write(f"    //{cur.nodeid}:{e.startdir()} -> "
                             f"{e.nodeid}:{e.destdir()}\n")
            fp.write("\n\n")
        fp.write("}\n")


def print_fasta(g, filename: str) -> None:
    """All node strings as FASTA contigs (ref: Graph.cc:1929-1960)."""
    with open(filename, "w") as fp:
        idx = 0
        for cur in g.node_iter():
            if cur.is_special():
                continue
            idx += 1
            fp.write(f">contig_{idx} len={cur.strlen()} "
                     f"cov={cur.tot_cov():.2f}\n{cur.str_m}\n")


def graph_stats(g, compid: int = 0) -> dict:
    """Stage statistics (ref: printStats Graph.cc:3662-3691)."""
    n = 0
    edges = 0
    tumor_only = 0
    for cur in g.node_iter():
        if compid and cur.component != compid:
            continue
        n += 1
        edges += len(cur.edges)
        if cur.is_tumor and not cur.is_normal:
            tumor_only += 1
    return {"nodes": n, "edges": edges, "tumor_only": tumor_only}


def print_pairs(g, filename: str) -> None:
    """All neighboring contig pairs (+ isolated contigs) as FASTA
    (ref: printPairs, Graph.cc:1963-2022 — dead debug export in the
    reference, carried for C17 completeness). Pair de-dup rule matches
    the reference: skip RR edges, and for non-FF edges require
    cur.nodeid < other.nodeid."""
    import sys

    from .node import FF, RR
    from .path import Path

    print(f"Saving pairs fasta: {filename}", file=sys.stderr)
    with open(filename, "w") as fp:
        nodes = 0
        for cur in g.node_iter():
            if not cur.edges:
                nodes += 1
                fp.write(f">{nodes}:{cur.nodeid} len={cur.strlen()} "
                         f"cov={cur.tot_cov():.2f}\n{cur.str_m}\n")
                continue
            for e in cur.edges:
                if e.dir == RR:
                    continue
                if e.dir == FF or cur.nodeid < e.nodeid:
                    nodes += 1
                    other = g.get_edge_node(e)
                    pairpath = Path(g.K)
                    pairpath.nodes = [cur, other]
                    pairpath.edgedir = [e.dir]
                    seq = pairpath.str()
                    fp.write(f">{nodes}:{pairpath.pathstr()} "
                             f"len={len(seq)} "
                             f"cov={pairpath.cov('T'):.2f}\n{seq}\n")
