"""Main read assigner CLI (reference: src/hmmufotu.cpp).

Counterpart of hmmufotu_tpu/cli/assign.py on one device: loads the
4-file DB, batch-aligns reads with the banded device Viterbi, places
them with the device SEP kernels, and writes the TSV with the
reference's column layout (hmmufotu.cpp:590-594).  Single-end reads
without chimera checking stream through pipeline.assign_stream;
paired-end mates, chimera checking and --align-only run the batch loop
of the reference package.  --mesh places each batch with its reads
split over the local devices, --mesh-tree with the tree's message
tensors split over them; --num-processes runs one process per shard of
the reads, whose rows process 0 gathers and writes (parallel/).
"""

from __future__ import annotations

import argparse
import io
import logging
import math
import os
import sys

import numpy as np

from . import PROG_NAME, prog_header, setup_logging
from .._cuda import resolve_device
from ..db import Database
from ..hmm import GLOBAL, NGCL, HmmAlignment, ViterbiAligner
from ..phylo import PTPlacement
from ..phylo.tree import (PLACEMENT_TSV_HEADER, UNASSIGNED_ID,
                          UNASSIGNED_TAXONID, UNASSIGNED_TAXONNAME, p_dist)
from ..seq import PrimarySeq, SeqWriter, read_seqs
from ..utils import trace
from .. import pipeline as pl

log = logging.getLogger(__name__)

ALN_TSV_HEADER = ("seq_start\tseq_end\thmm_start\thmm_end\tCS_start\t"
                  "CS_end\tcost\talignment")   # BandedHMMP7.cpp:51
CHIMERA_TSV_HEADER = ("seg5_taxon_id\tseg3_taxon_id\tseg5_taxon_anno\t"
                      "seg3_taxon_anno\tchimera_lod")  # hmmufotu.cpp:57
DEFAULT_BATCH = 64          # CPU default
DEFAULT_BATCH_GPU = 2048
STRAND_CONFIDENCE = 0.9     # hmmufotu.cpp:41
MIN_STRAND_TEST = 10
DEFAULT_COORDINATOR = "localhost:29500"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG_NAME,
        description="Ultra-fast microbiome amplicon sequencing read "
                    "taxonomy assignment (PyTorch/CUDA)")
    p.add_argument("db", help="database prefix")
    p.add_argument("reads", help="forward read file (fasta/fastq)")
    p.add_argument("mates", nargs="?", default="",
                   help="optional reverse read file")
    p.add_argument("-o", dest="out", default="-",
                   help="assignment TSV output")
    p.add_argument("-a", "--align-out", default="",
                   help="write aligned reads fasta")
    p.add_argument("-L", "--seed-len", type=int,
                   default=pl.DEFAULT_SEED_LEN)
    p.add_argument("-R", dest="seed_region", type=int,
                   default=pl.DEFAULT_SEED_REGION)
    p.add_argument("-s", "--strand", type=int, default=0,
                   choices=[0, 1, 2])
    p.add_argument("-t", "--test", type=int, default=MIN_STRAND_TEST)
    p.add_argument("-N", dest="max_nseed", type=int,
                   default=pl.DEFAULT_MAX_NSEED)
    p.add_argument("-d", "--max-diff", type=float, default=math.inf)
    p.add_argument("-H", "--max-height", type=float, default=math.inf)
    p.add_argument("-e", "--err", type=float,
                   default=pl.DEFAULT_MAX_PLACE_ERROR)
    p.add_argument("-m", "--method", default="unweighted",
                   choices=["unweighted", "weighted"])
    p.add_argument("--ML", action="store_true", dest="ml_only")
    p.add_argument("--ref-rank", action="store_true",
                   help="reference-binary compatibility ranking: pick "
                        "the candidate with the best ESTIMATE-stage "
                        "loglik, matching the v1.5.1 binary's "
                        "effective (degenerate) qPlace ordering — see "
                        "PARITY.md 'reference-binary parity'")
    p.add_argument("--prior", default="uniform",
                   choices=["uniform", "height"])
    p.add_argument("-C", "--chimera", action="store_true",
                   help="enable chimera checking")
    p.add_argument("--num-segment", type=int, default=2)
    # the reference initializes maxChimeraError = maxError / numSeg
    # BEFORE option parsing (hmmufotu.cpp:146-147 vs :225,:251), so its
    # default is the fixed 20/2 = 10.0 regardless of -e/--num-segment
    p.add_argument("--chimera-err", type=float,
                   default=pl.DEFAULT_MAX_PLACE_ERROR / 2)
    p.add_argument("--chimera-lod", type=float, default=0.0)
    p.add_argument("--chimera-out", default="")
    p.add_argument("--single", action="store_true",
                   help="assemble/single mode: GLOBAL alignment")
    p.add_argument("--ignore-orient", action="store_true")
    p.add_argument("--align-only", action="store_true")
    p.add_argument("-S", "--seed", type=int, default=None)
    p.add_argument("--opt-k", type=int, default=0,
                   help="speed knob: accurately optimize only the "
                        "opt-k best candidates by estimated loglik "
                        "(0 = all surviving candidates, "
                        "reference-faithful)")
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="reads per device batch (0 = auto: "
                        f"{DEFAULT_BATCH_GPU} on the GPU, {DEFAULT_BATCH} "
                        "on the CPU)")
    p.add_argument("--resume", action="store_true",
                   help="append to an existing output, skipping reads "
                        "already assigned (restartable batches)")
    p.add_argument("--resident-window", type=int, default=0,
                   metavar="WS",
                   help="single-chip capacity mode: keep only a "
                        "WS-column site window of the per-node "
                        "message tensors device-resident (chosen "
                        "from the first reads' aligned span; "
                        "reference-scale DBs exceed one chip's HBM "
                        "full-length).  Out-of-window reads fall back "
                        "to the exact host path")
    p.add_argument("--msg-bf16", action="store_true",
                   help="store the per-node message tensors as "
                        "bfloat16 (halves their HBM footprint; "
                        "compute stays f32)")
    p.add_argument("--mesh", action="store_true",
                   help="shard placement over all local devices "
                        "(data parallel: reads sharded, DB replicated)")
    p.add_argument("--mesh-tree", action="store_true",
                   help="shard the tree message tensors over all local "
                        "devices (capacity mode for DBs whose per-edge "
                        "messages exceed one chip's HBM)")
    p.add_argument("--coordinator", default=DEFAULT_COORDINATOR,
                   help="coordinator address for "
                        "multi-host runs")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes of a multi-host run; reads "
                        "are host-sharded and output rows gathered to "
                        "process 0 in order")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id in a multi-host run")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    return p


def aln_tsv(aln: HmmAlignment) -> str:
    return (f"{aln.seq_start}\t{aln.seq_end}\t{aln.hmm_start}\t"
            f"{aln.hmm_end}\t{aln.cs_start}\t{aln.cs_end}\t"
            f"{aln.cost:g}\t{aln.align}")


def place_tsv(tree, place: PTPlacement | None) -> str:
    if place is None or place.c_node < 0:
        return (f"{UNASSIGNED_ID}\tnan\t{UNASSIGNED_TAXONID}\t"
                f"{UNASSIGNED_TAXONNAME}\tnan\tnan\tnan\tnan")
    # the reference TSV anno_dist column is the PLACEMENT distance only
    # (PTPlacement::write, PhyloTreeUnrooted.h:1611-1616 + getAnnoDist
    # h:466-469)
    anno_dist = place.get_anno_dist(tree)
    return (f"{place.get_id()}\t{place.ratio:g}\t{place.a_node}\t"
            f"{tree.anno[place.a_node]}\t{anno_dist:g}\t"
            f"{place.loglik:g}\t{place.q_place:g}\t{place.q_taxon:g}")


def aligned_record(read, aln: HmmAlignment) -> PrimarySeq:
    """The --align-out fasta record of an aligned read."""
    desc = (read.desc + f";csStart={aln.cs_start}"
            f";csEnd={aln.cs_end};")
    return PrimarySeq(read.id, aln.align, desc)


def detect_strand(aligner, csfm, reads, mode, n_test, rng) -> int:
    """Strand auto-detection by alignment cost on the first reads
    (reference hmmufotu.cpp:500-545)."""
    from ..alphabet import DNA
    sample = reads[:n_test]
    fwd_alns = pl.align_reads(aligner, csfm, sample, mode=mode, rng=rng)
    rev_alns = pl.align_reads(aligner, csfm,
                              [DNA.revcom(r) for r in sample],
                              mode=mode, rng=rng)
    fwd = sum(f.cost < r.cost for f, r in zip(fwd_alns, rev_alns))
    rev = len(sample) - fwd
    if fwd >= (fwd + rev) * STRAND_CONFIDENCE:
        return 1
    if rev >= (fwd + rev) * STRAND_CONFIDENCE:
        return 2
    raise RuntimeError("Failed to determine read strandness; try larger "
                       "-t or set -s manually")


def check_chimera(tree, aln, seq, seeds, args):
    """Segment-placement chimera check (reference hmmufotu.cpp:653-691),
    on the host in f64.

    Returns (is_chimera, lod, best5, best3)."""
    num_seg = args.num_segment
    seg_len = (aln.cs_end - aln.cs_start + 1) // num_seg
    seg5, seg3 = [], []
    for n in range(num_seg):
        s0 = aln.cs_start + n * seg_len        # 1-based
        e0 = s0 + seg_len - 1
        seg_seeds = [
            type(s)(s0 - 1, e0 - 1, s.id,
                    p_dist(seq, tree.seqs[s.id], s0 - 1, e0 - 1))
            for s in seeds]
        places = pl.estimate_seq(tree, seq, seg_seeds, args.method)
        places = pl.filter_placements(places, args.chimera_err)
        places = pl.place_seq(tree, seq, places, args.max_height)
        (seg5 if n < num_seg // 2 else seg3).extend(places)
    seg5.sort(key=lambda p: -p.loglik)
    seg3.sort(key=lambda p: -p.loglik)
    b5, b3 = seg5[0], seg3[0]

    def alt(best, other):
        loc = type(seeds[0])(best.start, best.end, other.c_node,
                             p_dist(seq, tree.seqs[best.c_node],
                                    best.start, best.end))
        p = tree.estimate_seq(seq, loc, args.method)
        tree.place_seq(seq, p, args.max_height)
        return p

    alt5 = alt(b5, b3)
    alt3 = alt(b3, b5)
    lod = b5.loglik - alt5.loglik + b3.loglik - alt3.loglik
    is_chi = (b5.a_node != b3.a_node) and lod > args.chimera_lod
    return is_chi, lod, b5, b3


def read_done_ids(path: str) -> set[str]:
    """Ids of the reads an earlier run already wrote to `path`."""
    done = set()
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or line.startswith("id\t"):
                continue
            done.add(line.split("\t", 1)[0])
    return done


def main(argv=None, device="cuda") -> int:
    """Run the assigner; device="cuda" (default) or "cpu"."""
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose + 1)
    multihost = args.num_processes > 1
    if multihost:
        if args.process_id is None:
            log.error("--num-processes requires --process-id")
            return 1
        if not 0 <= args.process_id < args.num_processes:
            log.error("--process-id must be in [0, %d)",
                      args.num_processes)
            return 1
        if args.resume:
            log.error("--resume is not supported with --num-processes")
            return 1
        if args.seed is not None:
            # each process would draw the same rng over only its shard,
            # and the rows would differ from the single-process run's
            log.error("-S/--seed is not supported with --num-processes;"
                      " the default (deterministic first-occurrence "
                      "seed pick) is already reproducible")
            return 1
        from ..parallel.distributed import init_distributed
        if init_distributed(args.coordinator, args.num_processes,
                            args.process_id) != args.num_processes:
            # alone, process 0 would write only its own shard of the rows
            # and the others none (the reference CLI carries on so)
            log.error("could not join the %d-process group at %s",
                      args.num_processes, args.coordinator)
            return 1
        for attr in ("align_out", "chimera_out"):
            if getattr(args, attr):
                setattr(args, attr,
                        getattr(args, attr) + f".p{args.process_id}")
    dev = resolve_device(device)
    # without -S the FM-index occurrence choice is deterministic; -S
    # opts into reference-style random occurrence selection
    # (CSFMIndex::locateOne rand(), CSFMIndex.cpp:121-146)
    rng = np.random.default_rng(args.seed) if args.seed is not None \
        else None
    if not args.batch:
        args.batch = DEFAULT_BATCH_GPU if dev.type == "cuda" \
            else DEFAULT_BATCH

    db = Database.load(args.db)
    tree, hmm, csfm = db.ptu, db.hmm, db.csfm
    paired = bool(args.mates)
    mode = GLOBAL if (paired or args.single) else NGCL
    hmm.set_sequence_mode(mode)
    hmm.wing_retract()
    aligner = ViterbiAligner(hmm, device=dev)
    log.info("Database loaded: %d nodes, csLen %d, K %d",
             tree.num_nodes, tree.cs_len, hmm.K)

    from ..alphabet import DNA
    fwd_reads = list(read_seqs(args.reads))
    rev_reads = list(read_seqs(args.mates)) if paired else []
    if paired and len(rev_reads) != len(fwd_reads):
        log.error("Unmatched number of forward/reverse reads")
        return 1

    mesh = None
    if args.mesh and args.mesh_tree:
        log.error("--mesh and --mesh-tree are mutually exclusive")
        return 1
    if args.resident_window and (args.mesh or args.mesh_tree):
        log.error("--resident-window is the single-chip capacity "
                  "mode; use --mesh-tree to shard full-length "
                  "messages over a mesh instead")
        return 1
    if (args.mesh or args.mesh_tree) and not args.align_only:
        from ..parallel import make_mesh
        mesh = make_mesh(local=multihost, device=dev.type)
        log.info("Sharding %s over %d devices",
                 "tree messages" if args.mesh_tree
                 else "placement reads", mesh.size)

    strand = args.strand
    if strand == 0:
        strand = detect_strand(aligner, csfm,
                               [r.seq for r in fwd_reads], mode,
                               max(args.test, MIN_STRAND_TEST), rng)
        log.info("Read strand determined as %d", strand)
    if strand == 2:
        if paired:
            fwd_reads, rev_reads = rev_reads, fwd_reads
        else:
            for r in fwd_reads:
                r.seq = DNA.revcom(r.seq)

    # device placer for the batched SEP path; none under -C, whose chimera
    # check and the placement after it are host f64
    placer = None
    if not args.align_only and not args.chimera:
        import torch
        from ..phylo.placement import DevicePlacer
        site_window = None
        if args.resident_window:
            # resident span from the first reads' aligned window;
            # rng=None keeps the -S seeded Generator untouched
            sample = [r.seq for r in fwd_reads[:128]]
            sample_alns = pl.align_reads(aligner, csfm, sample,
                                         args.seed_len,
                                         args.seed_region, mode, None)
            scs = [a.cs_start - 1 for a in sample_alns if a.is_valid()]
            L = tree.cs_len
            W = min(512, L)
            Ws = min(max(args.resident_window, W), L)
            lo = min(scs) if scs else 0
            s0 = max(0, min(lo - lo % 128, L - Ws))
            site_window = (s0, Ws)
            log.info("Resident site window: [%d, %d) of %d columns",
                     s0, s0 + Ws, L)
        placer = DevicePlacer(
            tree, max_nseed=args.max_nseed, device=dev,
            opt_k=args.opt_k or None,
            msg_dtype=torch.bfloat16 if args.msg_bf16 else None,
            site_window=site_window, ref_rank=args.ref_rank)

    # restartable batches: on --resume, skip reads already present in
    # the output and append
    done_ids = set()
    mode_out = "w"
    if args.resume and args.out != "-" and os.path.exists(args.out):
        done_ids = read_done_ids(args.out)
        mode_out = "a"
        log.info("Resuming: %d reads already assigned", len(done_ids))
    if done_ids:
        keep = [t for t, r in enumerate(fwd_reads)
                if r.id not in done_ids]
        fwd_reads = [fwd_reads[t] for t in keep]
        if paired:
            rev_reads = [rev_reads[t] for t in keep]

    if multihost:
        # contiguous shard of the reads (strand detection above ran on
        # the whole list, so every process made the same choice)
        from ..parallel.distributed import host_bounds
        lo_h, hi_h = host_bounds(len(fwd_reads), args.process_id,
                                 args.num_processes)
        log.info("multihost: process %d/%d assigned reads [%d, %d)",
                 args.process_id, args.num_processes, lo_h, hi_h)
        fwd_reads = fwd_reads[lo_h:hi_h]
        if paired:
            rev_reads = rev_reads[lo_h:hi_h]

    chim_cols = ("\t" + CHIMERA_TSV_HEADER + "\t") if args.chimera \
        else "\t"
    header = ("id\tdescription\t" + ALN_TSV_HEADER + chim_cols
              + PLACEMENT_TSV_HEADER + "\n")
    if multihost:
        out = io.StringIO()        # rows gathered to process 0 at the end
    else:
        out = sys.stdout if args.out == "-" else open(args.out, mode_out)
    chi_out = aln_out = None
    try:
        if mode_out == "w" and (not multihost or args.process_id == 0):
            out.write(prog_header([PROG_NAME] + list(argv)))
            out.write(header)
        if args.chimera_out:
            chi_out = open(args.chimera_out, "w")
            chi_out.write(prog_header([PROG_NAME] + list(argv)))
            chi_out.write(header)
        if args.align_out:
            aln_out = SeqWriter(open(args.align_out, "w"))
        if not paired and not args.chimera and not args.align_only \
                and mesh is None:
            n_assigned = stream_single(args, aligner, csfm, tree, placer,
                                       fwd_reads, mode, rng, out, aln_out)
        else:
            n_assigned = batch_loop(args, aligner, csfm, tree, placer,
                                    fwd_reads, rev_reads, mode, rng, out,
                                    chi_out, aln_out, mesh)
        log.info("Assigned %d of %d reads", n_assigned, len(fwd_reads))
        if trace.ON:
            log_trace(placer)
    finally:
        for f in (chi_out, aln_out):
            if f:
                f.close()
        if out is not sys.stdout and not multihost:
            out.close()
    if multihost:
        write_gathered(args, out.getvalue(), mode_out)
    return 0


def log_trace(placer) -> None:
    """With the tracer on (HMMUFOTU_TIMING=1): its one-line summary at
    -v, and a warning where the placer cut reads to its window."""
    log.debug("%s", trace.summary())
    clamped = trace.counts().get("window_clamped", 0)
    if clamped:
        log.warning("%d reads span more than the placer's window of %d "
                    "CS columns; each was placed over its first %d",
                    clamped, placer.W, placer.W)


def write_gathered(args, text: str, mode_out: str) -> None:
    """Gather every process's rows to process 0, in process order (the
    order of the reads), which writes them: data rows byte-equal to a
    single-process run's.  Every process calls this."""
    from ..parallel.distributed import gather_host_text
    parts = gather_host_text(text)
    if args.process_id != 0:
        return
    f = sys.stdout if args.out == "-" else open(args.out, mode_out)
    try:
        for part in parts:
            f.write(part)
    finally:
        if f is not sys.stdout:
            f.close()


def stream_single(args, aligner, csfm, tree, placer, fwd_reads, mode, rng,
                  out, aln_out) -> int:
    """Single-end reads without chimera checking: the double-buffered
    stream (device work of the next batch overlaps host work).  Returns
    the number of reads assigned."""
    lo = n_assigned = 0
    for alns, best_batch in pl.assign_stream(
            aligner, csfm, tree, placer, [r.seq for r in fwd_reads],
            args.batch, args.seed_len, args.seed_region, mode, rng,
            args.max_diff, args.max_height, args.err, args.prior,
            args.ml_only):
        for t, aln in enumerate(alns):
            read = fwd_reads[lo + t]
            best = best_batch[t]
            if aln_out and aln.is_valid():
                aln_out.write(aligned_record(read, aln))
            if best is not None:
                n_assigned += 1
            out.write(f"{read.id}\t{read.desc}\t" + aln_tsv(aln)
                      + "\t" + place_tsv(tree, best) + "\n")
        lo += len(alns)
        out.flush()
        log.info("Processed %d reads", lo)
    return n_assigned


def batch_loop(args, aligner, csfm, tree, placer, fwd_reads, rev_reads,
               mode, rng, out, chi_out, aln_out, mesh=None) -> int:
    """Paired-end mates, chimera checking, --align-only or a mesh, one
    batch at a time (reference package's loop,
    hmmufotu_tpu/cli/assign.py:450-549); with a mesh each batch is placed
    over it (--mesh-tree: tree-sharded).  The -S rng is consumed by the
    forward reads' alignment, then by the reverse-complemented mates'.
    Returns the number of reads assigned."""
    from ..alphabet import DNA
    paired = bool(rev_reads)
    n_assigned = 0
    for lo in range(0, len(fwd_reads), args.batch):
        with trace.span("batch", batch=lo // args.batch):
            batch = fwd_reads[lo:lo + args.batch]
            alns = pl.align_reads(aligner, csfm, [r.seq for r in batch],
                                  args.seed_len, args.seed_region, mode, rng)
            rev_alns = [None] * len(batch)
            if paired:
                mates = [DNA.revcom(r.seq)
                         for r in rev_reads[lo:lo + args.batch]]
                rev_alns = pl.align_reads(aligner, csfm, mates,
                                          args.seed_len, args.seed_region,
                                          mode, rng)
            # orientation / merge pass
            chim_flags = [False] * len(batch)
            for t, (read, aln, rev_aln) in enumerate(
                    zip(batch, alns, rev_alns)):
                if paired and rev_aln is not None:
                    if not args.ignore_orient and not (
                            aln.cs_start <= rev_aln.cs_start
                            and aln.cs_end <= rev_aln.cs_end):
                        log.warning("Bad orientation of fwd/rev read %s, "
                                    "treating as chimera", read.id)
                        chim_flags[t] = True
                    else:
                        aln.merge(rev_aln)

            # batched device placement when no chimera check places on the
            # host
            best_batch = [None] * len(batch)
            if not args.align_only and not args.chimera:
                place_alns = [HmmAlignment() if chim_flags[t] else aln
                              for t, aln in enumerate(alns)]
                if args.mesh_tree:
                    best_batch = pl.assign_batch_device_tree(
                        tree, placer, place_alns, mesh, args.max_diff,
                        args.max_height, args.err, args.prior, args.ml_only)
                else:
                    best_batch = pl.assign_batch_device(
                        tree, placer, place_alns, args.max_diff,
                        args.max_height, args.err, args.prior, args.ml_only,
                        mesh=mesh)

            for t, (read, aln) in enumerate(zip(batch, alns)):
                is_chimera = chim_flags[t]
                seq = None
                seeds = []
                if args.chimera and not is_chimera:
                    seq = pl.aln_to_digital(tree, aln)
                    seeds = pl.get_seed(tree, seq, aln.cs_start - 1,
                                        aln.cs_end - 1, args.max_diff,
                                        args.max_height, args.max_nseed)
                lod = math.nan
                b5 = b3 = None
                if args.chimera and not is_chimera and seeds:
                    is_chimera, lod, b5, b3 = check_chimera(
                        tree, aln, seq, seeds, args)
                chim_str = ""
                if args.chimera:
                    if b5 is not None:
                        chim_str = (f"\t{b5.a_node}\t{b3.a_node}\t"
                                    f"{tree.anno[b5.a_node]}\t"
                                    f"{tree.anno[b3.a_node]}\t{lod:g}")
                    else:
                        chim_str = "\tnan\tnan\tnan\tnan\tnan"

                if is_chimera:
                    if chi_out:
                        chi_out.write(f"{read.id}\t{read.desc}\t"
                                      + aln_tsv(aln) + chim_str + "\t"
                                      + place_tsv(tree, None) + "\n")
                    continue
                if aln_out:
                    aln_out.write(aligned_record(read, aln))
                best = None
                if not args.align_only:
                    if args.chimera and seeds:
                        # chimera mode already has host seeds; finish the
                        # host SEP path with them
                        places = pl.estimate_seq(tree, seq, seeds,
                                                 args.method)
                        places = pl.filter_placements(places, args.err)
                        places = pl.place_seq(tree, seq, places,
                                              args.max_height)
                        if args.ml_only:
                            places.sort(key=lambda p: -p.loglik)
                        else:
                            pl.calc_q_values(tree, places, args.prior)
                            places.sort(key=lambda p: -p.q_place)
                        best = places[0]
                    elif not args.chimera:
                        best = best_batch[t]
                    if best is not None:
                        n_assigned += 1
                out.write(f"{read.id}\t{read.desc}\t" + aln_tsv(aln)
                          + chim_str + "\t" + place_tsv(tree, best) + "\n")
            out.flush()
            log.info("Processed %d reads", min(lo + args.batch,
                                               len(fwd_reads)))
    return n_assigned


if __name__ == "__main__":
    sys.exit(main())
