"""k3_roofline: K3 (csrc/place.cu sep_kernel): the least time the card could take for the work
its launches need (work.k3_work) over its device time in the trace, in %."""

import functools

from portbench.probes import roofline

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"
KERNELS = {"k3": "sep_kernel"}


def install(patches, store):
    """Record each K3 launch's masked sites a lane, live lanes, rates and
    trip counts, kept as tensors until the window has closed."""
    from hmmufotu_tpu_torch.phylo import cuda_place as cp
    store["launches"] = []

    def wrap(fn):
        @functools.wraps(fn)
        def rec(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s, n_rates):
            out = fn(Up, Vp, Np, maskp, w0, wur0, wnr0, live, model_s,
                     n_rates)
            store["launches"].append(((maskp > 0.5).sum(1), live.reshape(-1),
                                      int(n_rates), out[4], out[5]))
            return out
        return rec

    for name in ("sep_cuda", "sep_plain"):
        patches.set(cp, name, wrap(getattr(cp, name)))


def work(store):
    """(bytes, operations) summed over the recorded launches."""
    from portbench.work import k3_work
    if not store.get("launches"):
        return None
    b = o = 0.0
    for sites, live, n_rates, outer, inner in store["launches"]:
        nb, no = k3_work(sites.cpu().numpy(), live.cpu().numpy(), n_rates,
                         outer.cpu().numpy(), inner.cpu().numpy())
        b, o = b + nb, o + no
    return b, o


def read(run):
    return roofline(run, "k3", work)
