"""Quickstart: BRIDGE schedule synthesis + cost model in five minutes, on
the PyTorch port (`repro_torch.core`, NumPy on the host).

The twin of examples/quickstart.py: the same steps and the same printed
lines.  Like every entry point of the port it runs for the card unless
`--device cpu` is given; its work is all on the host.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import (baselines, collective_time, ocs_preset,
                              periodic_a2a, plan, rs_transmission_optimal)

MB = 1024.0 ** 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs without one")
    resolve_device(ap.parse_args(argv).device)
    n = 64  # GPUs on the optical ring

    print("=== 1. The paper's Table 1: where to reconfigure ===")
    for R in (1, 2):
        a2a = periodic_a2a(n, R)
        rs = rs_transmission_optimal(n, R)
        print(f" R={R}: all-to-all {a2a.x}  (periodic)")
        print(f"       reduce-scatter {rs.x}  (early)")

    print("\n=== 2. How much does one reconfiguration buy? (A2A, 4 MB) ===")
    cm = ocs_preset("rotornet_infocus")  # 10 us reconfiguration delay
    static = collective_time(periodic_a2a(n, 0), 4 * MB, cm)
    one = collective_time(periodic_a2a(n, 1), 4 * MB, cm)
    print(f" static ring : {static.total * 1e3:8.3f} ms "
          f"(hops {static.hop_latency * 1e3:.3f} ms, "
          f"tx {static.transmission * 1e3:.3f} ms)")
    print(f" R=1 subrings: {one.total * 1e3:8.3f} ms "
          f"(incl. {one.reconfig * 1e6:.0f} us reconfig) "
          f"-> {static.total / one.total:.2f}x")

    print("\n=== 3. Optimal R, per Section 3.6 ===")
    for m in (64e3, 4 * MB, 256 * MB):
        p = plan("a2a", n, m, cm, paper_faithful=True)
        print(f" m={m / MB:8.3f} MB: {p.strategy:<16s} "
              f"t={p.predicted_time * 1e3:8.3f} ms")

    print("\n=== 4. AllReduce: BRIDGE vs the bandwidth-optimal RING ===")
    cm_ar = cm.replace(delta=150e-6)  # paper Fig. 9: delta = 0.15 ms case
    for m in (64e3, 4 * MB, 256 * MB):
        t_bridge = baselines.bridge_allreduce(n, m, cm_ar).total
        t_ring = baselines.ring("ar", n, m, cm_ar).total
        winner = "BRIDGE" if t_bridge < t_ring else "RING"
        print(f" m={m / MB:8.3f} MB: bridge {t_bridge * 1e3:8.3f} ms "
              f"ring {t_ring * 1e3:8.3f} ms -> {winner}")
    print("\n(large messages -> RING wins: exactly the paper's Fig. 9/12.)")


if __name__ == "__main__":
    main()
