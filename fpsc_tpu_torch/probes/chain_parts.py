"""Where a product of the chain kernels spends its time.

    python -m fpsc_tpu_torch.probes.chain_parts [m] [k] [b]

Every arm of probe_i8_matmul runs on thread-block clusters of 1 to 8
CTAs (portable) or 16 (non-portable), 8 columns of x a cluster.  For
each arm and each cluster size of CLUSTERS at which W's stripe fits a
CTA's shared memory (a line says where it does not): one line for the
chain itself (held to the plain version by the probe's check first);
one for a chain of one product (what the launch, the load of W and the
staging of x cost); and, for the bf16 and i8 arms, one for each timing
variant of the kernel that leaves parts of every product out: the
products, the stores of x to the cluster's peers (each CTA then arrives
on its peers' barriers in their place), or both (what is left is the
synchronisation: a __syncthreads, the arrivals and a wait on the CTA's
mbarrier).  The onehot kernel exchanges nothing and has no variants.
Each line: the median ms of one chain of ITERS products (the probe's
timer) and its us a product.  Without a card it raises.
"""
from __future__ import annotations

import sys
from typing import Dict

from fpsc_tpu_torch.probes import probe_i8_matmul as pim
from fpsc_tpu_torch.probes.timing import card, median_ms
from fpsc_tpu_torch.utils.device import resolve_device

CLUSTERS = (2, 4, 6, 8, 16)
VARIANTS = {"bf16": ((), ("exchange",), ("products",),
                     ("products", "exchange")),
            "onehot": ((),)}
VARIANTS["i8"] = VARIANTS["bf16"]


def main(m: int = pim.DEFAULT[0], k: int = pim.DEFAULT[1],
         b: int = pim.DEFAULT[2], device=None) -> Dict[tuple, float]:
    """Time each arm's chain and its variants at each of CLUSTERS ->
    {(arm, CTAs a cluster, what is left out): ms}."""
    dev = resolve_device(device)
    name = card(dev)
    times = {}
    for arm in pim.ARMS:
        w, x = pim.operands(arm, m, k, b, dev)
        want = pim.run_plain(arm, w, x)
        for ctas in CLUSTERS:
            smem = pim.cluster_smem(m, k, ctas, arm)
            if smem > pim.SMEM_BYTES:
                print(f"{arm} chain on clusters of {ctas} CTAs: W's stripe "
                      f"needs {smem} bytes a CTA, more than "
                      f"{pim.SMEM_BYTES} [{name}]", flush=True)
                continue
            pim.check(arm, pim.run_chain(arm, w, x, ctas=ctas), want)
            ms = median_ms(lambda: pim.run_chain(arm, w, x, iters=1,
                                                 ctas=ctas), x)
            print(f"{arm} chain on clusters of {ctas} CTAs, one product: "
                  f"{ms:.4f} ms [{name}]", flush=True)
            times[arm, ctas, "one product"] = ms
            for skip in VARIANTS[arm]:
                ms = median_ms(lambda: pim.run_chain(arm, w, x, ctas=ctas,
                                                     skip=skip), x)
                what = " without the " + " and the ".join(skip) if skip \
                    else ""
                print(f"{arm} chain on clusters of {ctas} CTAs{what}: "
                      f"{ms:.4f} ms, {ms * 1e3 / pim.ITERS:.3f} us a "
                      f"product [{name}]", flush=True)
                times[arm, ctas, skip] = ms
    return times


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
