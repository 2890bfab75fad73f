"""Optimizer-only scaling microbenchmark (port of examples/optimization_time.py;
reference M3T/examples/optimization_time.cpp:11-80).

Builds a kinematic chain of 1-N links under one Optimizer, adds synthetic gradients and
Hessians to its links, and times ``CalculateOptimization`` in ms per solve.  The solve
is the Optimizer's host numpy Newton step in both packages, so this script times host
time whatever ``--device`` says; ``--device`` is checked as in every entry point of the
port (without a card, ``cuda`` raises).  Two things of the JAX script are kept as they
are (ROADMAP Queue C): its docstring promises a batched on-device solve that its code
does not run (the benchmark's kinematic cell times the batched KKT solve on the card:
``kin_stage_ms.kkt_solve``), and the step recomputes each link's terms from its
modalities, of which the chain has none, so the added terms are dropped and every timed
solve is a zero step.

Usage: python -m m3t_tpu_torch.examples.optimization_time [--max-chain 20] [--n-runs 200]
       [--device cuda]
"""

import argparse
import time

import numpy as np

from m3t_tpu_torch.common import np_pose, resolve_device
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer


def make_chain(n_bodies: int):
    """A root link 0.5 m along z and n_bodies - 1 links 5 cm apart along x, each free
    in its joint's z rotation only, under one Optimizer."""
    links = []
    root = Link("link_0", joint2parent_pose=np_pose(translation=[0, 0, 0.5]))
    root.SetUp()
    links.append(root)
    for i in range(1, n_bodies):
        link = Link(f"link_{i}", joint2parent_pose=np_pose(translation=[0.05, 0, 0]),
                    free_directions=[False, False, True, False, False, False])
        link.SetUp()
        links[-1].AddChildLink(link)
        links[-1].SetUp()
        links.append(link)
    optimizer = Optimizer("optimizer", root)
    if not optimizer.SetUp():
        raise RuntimeError(f"the optimizer of a {n_bodies}-link chain failed to set up")
    return optimizer, links


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--max-chain", type=int, default=20)
    parser.add_argument("--n-runs", type=int, default=200)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    rng = np.random.default_rng(0)
    print(f"{'chain':>6} {'dof':>5} {'ms/solve':>10}")
    for n_bodies in [1, 2, 5, 10, args.max_chain]:
        optimizer, links = make_chain(n_bodies)
        # Inject synthetic gradients/Hessians like real modalities would.
        for link in links:
            g = rng.normal(size=6).astype(np.float32)
            h = -np.eye(6, dtype=np.float32) * rng.uniform(10, 100)
            link.AddToGradientAndHessian(g, h)

        begin = time.perf_counter()
        for _ in range(args.n_runs):
            optimizer.CalculateOptimization(0, 0, 0)
        elapsed = (time.perf_counter() - begin) / args.n_runs * 1000.0
        print(f"{n_bodies:>6} {optimizer.degrees_of_freedom:>5} {elapsed:>10.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
