"""BASELINE config #5 through the PyTorch port's CLIs at the gg_97 width:
multi-sample assign -> sum -> merge.

The port's counterpart of scripts/scale_sum.py.  Where that script
amplifies one fixture assign run into 3 x 100,000 TSV rows, this one
runs what a config #5 user runs, each CLI in a process of its own
(scripts/torch_scale_cli.py's child runner): the build CLI writes the
DB files once, the assign CLI assigns every sample's reads on the card,
one `sum` a host joins its samples into an OTU table, and `merge` joins
the hosts' tables.  Two hosts are emulated on one machine: host A sums
samples 0 .. S-2, host B sample S-1.  Steps:

  1. inputs  the evolved tree of scripts/evolved_inputs.py (MSA fasta,
             Newick, taxonomy); --samples read files of --sample-reads
             250 bp amplicon reads (2% substitutions) from one
             --region-column region.  Each sample is a community of its
             own: 1,000 leaves common to every sample and 1,000 of its
             own (on a small tree, 1/(S+1) of its leaves each), each with
             a lognormal(0, 1.5) abundance; reads are drawn in proportion
             to it (seeds --seed and the sample index);
  2. build   the build CLI with -s GTR --msg-dtype f32 --eval-engine
             torch, skipped under --reuse-db when --work holds the DB
             files of the same shape;
  3. assign  the assign CLI with its default flags (the whole tree on the
             card) on each sample: Database.load (by file, and the
             .ptu.npz by member), upload and stream clocks, reads/s,
             the Processed timeline and the rates of 10 batches after
             the first and of the last 10, peak RSS, device
             peak, K1-K3 launches and CUDA-event milliseconds, the TSV's
             bytes;
             sample 0 also the parity of its first --parity reads against
             the exact host path (under 95% by either count fails);
  4. sum     one sum CLI a host over its samples' TSVs with -s -l -c -t
             (defaults -n 0 -m 0 -q 0): load, parse, encode, accumulate,
             table, consensus and tree clocks, OTUs, peak RSS;
  5. merge   merge A.tsv B.tsv -o merged.tsv -db <prefix> -t merged.nwk:
             load (the tree's topology alone, Database.load_topology),
             the tables' load and +=, tree clocks, peak RSS;
  6. gates   every CLI exits 0; each sample TSV has --sample-reads rows;
             the merged table equals an independent count of each
             sample's TSV rows by taxon_id (>= 0); its total equals the
             assigned rows; each host's consensus FASTA has one record of
             the alignment's width for each OTU of its table; merged.nwk
             parses and names every merged OTU.  Any failure: rc 1;
  7. one JSON line, the last the script prints, with every number, the
             card line and `free -g`'s total (keys of scale_sum.py's line
             where they mean the same); --progress FILE gets the numbers
             so far after each step.

    python scripts/torch_scale_sum.py --leaves 75000 --length 6000 \\
        --samples 3 --sample-reads 100000 --progress out/torch_scale_sum.json
(--leaves 75000 is the gg_97 shape, 149,999 nodes; --leaves 50000, the
default, is 99,999 nodes.)  `reduced` lists the reads a sample and,
below 75,000 leaves, the nodes.
CPU smoke:
    python scripts/torch_scale_sum.py --leaves 64 --length 600 \\
        --region 400 --samples 3 --sample-reads 48 --batch 24 \\
        --parity 8 --eval-engine numpy --device cpu --work /tmp/sum

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, SCRIPTS)

from evolved_inputs import (READ_LEN, input_tree,  # noqa: E402
                            simulate_reads, synth_inputs)
from torch_scale_assign import site_window  # noqa: E402
from torch_scale_cli import (build_db, free_total_gb, log,  # noqa: E402
                             run_child, stream_rates)
from torch_scale_eval import card_line  # noqa: E402

GG97_NODES = 149999
OTU_PREFIX = "OTU_"        # the sum CLI's default -p
COMMUNITY_LEAVES = 1000    # leaves every sample shares; and its own


# ---------------------------------------------------------------------------
# the samples: one community each
# ---------------------------------------------------------------------------

def region_bases(tree, region) -> np.ndarray:
    """Bases of each node's sequence in MSA columns [lo, hi)."""
    lo, hi = region
    return (tree.seqs[:, lo:hi] >= 0).sum(1)


def eligible_leaves(tree, region, length: int = READ_LEN) -> list[int]:
    """The leaves that hold a read's worth of bases in the region."""
    held = region_bases(tree, region)
    return [u for u in range(tree.num_nodes)
            if tree.is_leaf(u) and tree.msa_id[u] >= 0
            and held[u] >= length + 10]     # simulate_reads' rule


def communities(tree, n_samples: int, shared: int, own: int, seed: int,
                region, length: int = READ_LEN) -> list[np.ndarray]:
    """Each sample's leaves: `shared` leaves common to every sample, then
    `own` of its own, drawn without replacement (rng seed `seed`) from
    eligible_leaves."""
    leaves = eligible_leaves(tree, region, length)
    need = shared + n_samples * own
    if need > len(leaves):
        raise ValueError(f"{need} community leaves asked for, the region "
                         f"holds reads of {len(leaves)}")
    pick = np.random.default_rng(seed).choice(leaves, need, replace=False)
    return [np.concatenate([pick[:shared],
                            pick[shared + s * own:shared + (s + 1) * own]])
            for s in range(n_samples)]


def sample_reads(tree, leaves, n: int, seed: int, sample: int, region):
    """n reads of one community: each leaf gets a lognormal(0, 1.5)
    abundance and reads are drawn in proportion to it, then shuffled
    (rng seeded by (seed, sample)).  Returns (reads, source leaf of
    each)."""
    if (region_bases(tree, region)[leaves] < READ_LEN + 10).any():
        # simulate_reads would draw from such a leaf forever
        raise ValueError("a community leaf holds no read in the region")
    rng = np.random.default_rng([seed, sample])
    w = rng.lognormal(0.0, 1.5, len(leaves))
    counts = rng.multinomial(n, w / w.sum())
    reads, src = [], []
    for u, k in zip(leaves.tolist(), counts.tolist()):
        if k:
            reads += simulate_reads(tree, rng, k, leaves=[u], region=region)
            src += [u] * k
    order = rng.permutation(n)
    return [reads[i] for i in order], np.asarray(src)[order]


def write_sample(path: str, sample: int, reads) -> str:
    """FASTA of one sample; read ids s<sample>_r<i> are unique over the
    samples, so the read lists of one sum name each read once."""
    with open(path, "w") as fh:
        fh.write("".join(f">s{sample}_r{i}\n{s}\n"
                         for i, s in enumerate(reads)))
    return path


# ---------------------------------------------------------------------------
# what the outputs are checked against: the TSVs themselves
# ---------------------------------------------------------------------------

def taxon_counts(tsv: str) -> tuple[Counter, int]:
    """Rows of an assignment TSV by taxon_id (>= 0), read straight from
    its columns; and the number of rows."""
    counts, n_rows, col = Counter(), 0, None
    with open(tsv) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if col is None:
                col = f.index("taxon_id")
                continue
            n_rows += 1
            taxon = int(f[col])
            if taxon >= 0:
                counts[taxon] += 1
    return counts, n_rows


def read_table(path: str) -> tuple[list[str], dict[str, list[float]]]:
    """(sample names, OTU id -> counts) of an OTU table file."""
    samples, rows = None, {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if samples is None:
                samples = f[1:-1]
                continue
            rows[f[0]] = [float(x) for x in f[1:-1]]
    return samples or [], rows


def count_gate(sample_counts: dict[str, Counter], merged: str,
               prefix: str = OTU_PREFIX) -> dict:
    """The merged table against the independent counts: for every sample
    and every OTU, its count equals the sample's rows with that
    taxon_id; no OTU more or fewer; its total equals the assigned
    rows."""
    samples, table = read_table(merged)
    want = {f"{prefix}{t}" for c in sample_counts.values() for t in c}
    missing = sorted(want - set(table))
    extra = sorted(set(table) - want)
    mismatches = []
    for name, counts in sample_counts.items():
        if name not in samples:
            mismatches.append([name, None, None, None])
            continue
        j = samples.index(name)
        for otu, row in table.items():
            taxon = int(otu[len(prefix):]) if otu.startswith(prefix) \
                else None
            if row[j] != counts.get(taxon, 0):
                mismatches.append([name, otu, row[j], counts.get(taxon, 0)])
    assigned = sum(sum(c.values()) for c in sample_counts.values())
    total = sum(sum(r) for r in table.values())
    return {"ok": not missing and not extra and not mismatches
            and total == assigned and sorted(samples)
            == sorted(sample_counts),
            "merged_otus": len(table), "merged_total_reads": int(total),
            "assigned_rows": assigned, "missing": missing[:10],
            "extra": extra[:10], "mismatches": mismatches[:10],
            "n_mismatches": len(mismatches)}


def consensus_gate(cs_fasta: str, table: str, L: int) -> dict:
    """One consensus record of L columns for each OTU of the table."""
    from hmmufotu_tpu_torch.seq import read_seqs
    recs = list(read_seqs(cs_fasta))
    otus = set(read_table(table)[1])
    ids = [r.id for r in recs]
    n_bad_len = sum(len(r.seq) != L for r in recs)
    return {"ok": sorted(ids) == sorted(otus) and n_bad_len == 0,
            "records": len(recs), "otus": len(otus),
            "bad_length": n_bad_len}


def newick_gate(nwk: str, otus) -> dict:
    """The OTU tree parses with the port's parser and names every OTU."""
    from hmmufotu_tpu_torch.phylo import parse_newick
    with open(nwk) as fh:
        root = parse_newick(fh.read())
    names = {node.name for node in root}
    unnamed = sorted(set(otus) - names)
    return {"ok": not unnamed, "nodes": len(names), "unnamed": unnamed[:10]}


def loop_seconds(stamps) -> float | None:
    """Seconds of the sum CLI's parse-and-accumulate loop, from its first
    "Processing sample" log line to "Computing OTUTable"."""
    start = [t for t, m in stamps if m.startswith("Processing sample")]
    end = [t for t, m in stamps if m.startswith("Computing OTUTable")]
    return end[-1] - start[0] if start and end else None


def otu_gates(tsvs: dict, rows: dict, sums: dict, merged: str, nwk: str,
              L: int) -> dict:
    """Every gate on the OTU outputs: each sample TSV (tsvs: sample name
    -> path) has its expected rows; count_gate on the merged table;
    consensus_gate on each host's outputs (sums: host -> the sum CLI's
    output paths by flag); newick_gate on the merged OTU tree."""
    counts, n_rows = {}, {}
    for name, path in tsvs.items():
        counts[name], n_rows[name] = taxon_counts(path)
    gates = {"rows": n_rows, "count": count_gate(counts, merged),
             "consensus": {h: consensus_gate(o["-c"], o["-o"], L)
                           for h, o in sums.items()},
             "newick": newick_gate(nwk, read_table(merged)[1])}
    fails = [f"{k}: {v} rows, not {rows[k]}" for k, v in n_rows.items()
             if v != rows[k]]
    fails += [g for g in ("count", "newick") if not gates[g]["ok"]]
    fails += [f"consensus {h}" for h, g in gates["consensus"].items()
              if not g["ok"]]
    gates.update(ok=not fails, fails=fails)
    return gates


def sum_outputs(d: str, host: str) -> dict:
    """The sum CLI's output paths of one host, by flag: the OTU table,
    read list, consensus FASTA and OTU tree."""
    return {k: os.path.join(d, f"{host}{suf}") for k, suf in (
        ("-o", ".tsv"), ("-l", "_reads.tsv"), ("-c", "_cs.fasta"),
        ("-t", ".nwk"))}


def sum_argv(prefix: str, tsvs: dict, outs: dict) -> list[str]:
    """The sum CLI's command line for one host's samples (name -> TSV)
    at its defaults -n 0 -m 0 -q 0."""
    return ([prefix] + list(tsvs.values()) + ["-s"] + list(tsvs)
            + [x for k, p in outs.items() for x in (k, p)])


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=50000)
    ap.add_argument("--length", type=int, default=6000)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--sample-reads", type=int, default=100000)
    ap.add_argument("--region", type=int, default=1024,
                    help="columns of the amplicon region")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--batch", type=int, default=0,
                    help="assign -b (0: the CLI's default)")
    ap.add_argument("--parity", type=int, default=128,
                    help="sample 0's reads held against the host path")
    ap.add_argument("--eval-engine", default="torch",
                    choices=["torch", "numpy"])
    ap.add_argument("--work", default=os.path.join(
        REPO, ".bench", "torch_scale_sum"),
        help="directory of the inputs, DB files, TSVs and tables")
    ap.add_argument("--reuse-db", action="store_true",
                    help="skip the build when --work holds DB files of "
                         "this shape")
    ap.add_argument("--progress", default="",
                    help="JSON file holding the numbers so far")
    ap.add_argument("--why", default="",
                    help="why --leaves is below the gg_97 shape's (the "
                         "reads' cut and the emulated merge are given)")
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only when asked for")
    args = ap.parse_args(argv)
    if args.samples < 2:
        ap.error("--samples must be at least 2 (two hosts)")

    from hmmufotu_tpu_torch._cuda import resolve_device
    dev = resolve_device(args.device)
    S, n = args.samples, args.sample_reads
    names = [f"s{s}" for s in range(S)]
    hosts = {"A": names[:-1], "B": names[-1:]}
    n_nodes = 2 * args.leaves - 1
    # the reads are always cut; the nodes where --leaves is below gg_97's
    cuts = ([("leaves", f"{GG97_NODES:,} nodes", f"{n_nodes:,} nodes")]
            if n_nodes < GG97_NODES else [])
    cuts.append(("reads a sample", "100M+ reads", f"{S} x {n:,}"))
    res = {"samples": S, "reads_per_sample": n, "rows_expected": S * n,
           "device": str(dev), "card": card_line(dev),
           "free_total_gb": free_total_gb(), "leaves": args.leaves,
           "length": args.length, "eval_engine": args.eval_engine,
           "hosts": hosts,
           "reduced": {k: "; ".join(c[i] for c in cuts)
                       for i, k in enumerate(("what", "from", "to"))}}
    res["reduced"]["why"] = "; ".join([w for w in [args.why] if w] + [
        f"{S} x {n:,} reads fit one chip call with the build and every "
        "load", "the two hosts' merge is emulated on one machine (two "
        "sums, then merge): neither package has a collective on a CLI "
        "path"])
    log("reduced " + json.dumps(res["reduced"]))

    def progress():
        if args.progress:
            os.makedirs(os.path.dirname(os.path.abspath(args.progress)),
                        exist_ok=True)
            with open(args.progress, "w") as fh:
                json.dump(res, fh)

    # ---- 1. inputs ------------------------------------------------------
    d = args.work
    t = time.perf_counter()
    log("inputs...")
    res["n_nodes"], res["depth"] = synth_inputs(d, args.leaves, args.length)
    res["t_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tree = input_tree(d)
    L = tree.cs_len
    r0, Wr = site_window(L, args.region)
    region = (r0, r0 + Wr)
    # COMMUNITY_LEAVES shared and as many of its own a sample, fewer
    # where the tree has not that many leaves
    k = min(COMMUNITY_LEAVES, len(eligible_leaves(tree, region)) // (S + 1))
    comm = communities(tree, S, k, k, args.seed, region)
    fastas = []
    for s in range(S):
        reads, _ = sample_reads(tree, comm[s], n, args.seed, s, region)
        fastas.append(write_sample(os.path.join(d, f"{names[s]}.fasta"),
                                   s, reads))
    del tree, reads
    res.update(cs_len=L, amplicon_region=list(region),
               community_leaves=[len(c) for c in comm],
               distinct_leaves=len(set(np.concatenate(comm).tolist())),
               t_reads_s=time.perf_counter() - t)
    if dev.type == "cuda":
        # built before the CLIs run, so that no stream pays for nvcc
        from hmmufotu_tpu_torch import _cuda
        t = time.perf_counter()
        _cuda.build_all()
        res["t_kernel_build_s"] = time.perf_counter() - t
    progress()

    # ---- 2. build -------------------------------------------------------
    prefix, res["build"] = build_db(args, d, args.reuse_db)
    progress()
    if res["build"]["rc"] != 0:
        print(json.dumps(res))
        return 1

    # ---- 3. assign, once a sample ---------------------------------------
    fails = []
    t_after_build = time.perf_counter()
    tsvs, res["assign"] = {}, []
    for s, name in enumerate(names):
        tsv = tsvs[name] = os.path.join(d, f"{name}.tsv")
        argv_a = [prefix, fastas[s], "-o", tsv] + (
            ["-b", str(args.batch)] if args.batch else [])
        a = run_child("assign", argv_a, args, tsv,
                      parity=args.parity if s == 0 else 0,
                      kernels=dev.type == "cuda")
        stamps = a.pop("stamps", [])
        a["sample"] = name
        a["processed"] = [[t, int(m.split()[1])] for t, m in stamps
                          if m.startswith("Processed ")]
        stream_s = a.get("clocks", {}).get("stream_s")
        if stream_s:
            a["reads_per_s"] = n / stream_s
            a["rates"] = stream_rates(a["processed"], stream_s)
        a["tsv_bytes"] = os.path.getsize(tsv) if os.path.exists(tsv) \
            else None
        res["assign"].append(a)
        log(f"assign {name}: " + json.dumps(
            {k: v for k, v in a.items() if k != "processed"}))
        if a["rc"] != 0 or a["exit"] != 0:
            fails.append(f"assign {name} rc {a['rc']} exit {a['exit']}")
        if "launches" in a and min(a["launches"].values()) <= 0:
            fails.append(f"assign {name} launches {a['launches']}")
        if s == 0 and args.parity:
            P = a.get("parity_reads", 0)
            if not (P > 0 and min(a["parity_cnode_match"],
                                  a["parity_loglik_match"]) >= 0.95 * P
                    and a["parity_tsv_rows_equal"] == a["parity_rows"]):
                fails.append(f"parity of {name}")
        progress()
    if fails:
        res.update(gates={"ok": False, "fails": fails})
        progress()
        print(json.dumps(res))
        return 1

    # ---- 4. sum, once a host --------------------------------------------
    res["sum"] = {}
    for h, members in hosts.items():
        outs = sum_outputs(d, h)
        argv_s = sum_argv(prefix, {m: tsvs[m] for m in members}, outs)
        r = run_child("sum", argv_s, args)
        r["loop_s"] = loop_seconds(r.pop("stamps", []))
        r.update(argv=argv_s, outputs=outs)
        if r["rc"] == 0:
            r["otus"] = len(read_table(outs["-o"])[1])
        res["sum"][h] = r
        log(f"sum {h}: " + json.dumps(r))
        if r["rc"] != 0 or r["exit"] != 0:
            fails.append(f"sum {h} rc {r['rc']} exit {r['exit']}")
        progress()

    # ---- 5. merge ---------------------------------------------------------
    merged, nwk = os.path.join(d, "merged.tsv"), os.path.join(d,
                                                               "merged.nwk")
    argv_m = [res["sum"][h]["outputs"]["-o"] for h in hosts] + [
        "-o", merged, "-db", prefix, "-t", nwk]
    m = run_child("merge", argv_m, args)
    m.pop("stamps", None)
    m.update(argv=argv_m, outputs={"-o": merged, "-t": nwk})
    res["merge"] = m
    log("merge: " + json.dumps(m))
    if m["rc"] != 0 or m["exit"] != 0:
        fails.append(f"merge rc {m['rc']} exit {m['exit']}")
    wall_after = time.perf_counter() - t_after_build
    runs = res["assign"] + list(res["sum"].values()) + [m]
    loads = sum(r.get("clocks", {}).get("load_s", 0.0) for r in runs)
    res.update(
        t_sum_s=sum(r["wall_s"] for r in res["sum"].values()),
        t_merge_s=m["wall_s"], t_after_build_s=wall_after,
        t_loads_s=loads, load_share=loads / wall_after,
        peak_rss_gb=max(r.get("peak_rss_gb") or 0.0
                        for r in runs + [res["build"]]))
    progress()

    # ---- 6. gates ---------------------------------------------------------
    t = time.perf_counter()
    if fails:
        res["gates"] = {"ok": False, "fails": fails}
    else:
        gates = res["gates"] = otu_gates(
            tsvs, dict.fromkeys(names, n),
            {h: r["outputs"] for h, r in res["sum"].items()}, merged, nwk,
            L)
        gates["t_s"] = time.perf_counter() - t
        res.update(merged_otus=gates["count"]["merged_otus"],
                   merged_total_reads=gates["count"]["merged_total_reads"])
    progress()
    print(json.dumps(res))
    return 0 if res["gates"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
