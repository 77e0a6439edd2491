"""k1_roofline: K1 (csrc/viterbi.cu viterbi_kernel): the least time the card could take for the
work its launches need (work.k1_work) over its device time in the trace, in %."""

import functools

from portbench.probes import roofline

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"
KERNELS = {"k1": "viterbi_kernel"}


def install(patches, store):
    """Record each K1 launch's band table, rows, profile length and
    region count, kept as tensors until the window has closed."""
    from hmmufotu_tpu_torch.hmm import cuda_viterbi as cv
    store["launches"] = []

    def wrap(fn):
        @functools.wraps(fn)
        def rec(tc, em, scal, codes, meta, jb, n_rows, K, *rest):
            out = fn(tc, em, scal, codes, meta, jb, n_rows, K, *rest)
            n_regions = rest[2] if len(rest) > 2 else None
            store["launches"].append((meta, int(n_rows), int(K), n_regions))
            return out
        return rec

    for name in ("viterbi_traced_cuda", "viterbi_traced_plain"):
        patches.set(cv, name, wrap(getattr(cv, name)))


def work(store):
    """(bytes, operations) summed over the recorded launches."""
    from hmmufotu_tpu_torch.hmm.viterbi import MAX_REGIONS, REGION_WIDTH
    from portbench.work import k1_work
    if not store.get("launches"):
        return None
    b = o = 0.0
    for meta, n_rows, K, n_regions in store["launches"]:
        nb, no = k1_work(meta.cpu().numpy(), n_rows, K,
                         n_regions or MAX_REGIONS, MAX_REGIONS, REGION_WIDTH)
        b, o = b + nb, o + no
    return b, o


def read(run):
    return roofline(run, "k1", work)
