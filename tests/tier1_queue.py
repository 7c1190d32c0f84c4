"""Per-file seconds of a tier-1 run and a replay of its queue.

    python tests/tier1_queue.py JUNIT_XML [--move SRC:DST ...]
        [--scale FILE:FACTOR ...] [--jitter N]

Reads the per-test seconds of a junit file written by the tier-1 command
(``--junitxml``), prints each file's tests and seconds in the order that
pytest-xdist 3.8.0's ``--dist loadfile`` queues them, and replays that
queue on the same seconds: the files sorted by their number of tests,
largest first (ties in collection order), one file to each worker, then
another file to every worker that has at most 2 tests pending, at the
start and after each test (``LoadScopeScheduling.schedule`` and
``_reschedule``), on the tier-1 command's 6 workers. The replay leaves
out the start-up before the first test. ``--move`` puts a file's tests
into another file, ``--scale`` multiplies a file's seconds, both to try
a layout before paying for a run; ``--jitter N`` replays N times with
each test's seconds drawn from +-10% and prints the median, 90th
percentile and worst end.
"""

import argparse
import collections
import heapq
import random
import statistics
import xml.etree.ElementTree as ET

WORKERS = 6  # the tier-1 command's ``-n 6`` (ROADMAP.md, "Tier-1 verify")


def read_junit(path):
    """{file: [seconds of each test, in run order]} in collection order."""
    files = {}
    for case in ET.parse(path).iter("testcase"):
        parts = case.get("classname").split(".")
        name = "/".join(parts[:2]) + ".py"
        files.setdefault(name, []).append(float(case.get("time")))
    return dict(sorted(files.items()))


def queue_order(files):
    return sorted(files, key=lambda f: -len(files[f]))


def replay(files, rnd=None):
    """-> (end seconds, {worker: [files in the order it took them]})."""
    queue = collections.deque(queue_order(files))
    pending = {w: collections.deque() for w in range(WORKERS)}
    taken = {w: [] for w in range(WORKERS)}

    def hand(w):
        name = queue.popleft()
        taken[w].append(name)
        pending[w].extend(t * (rnd.uniform(0.9, 1.1) if rnd else 1.0)
                          for t in files[name])

    for w in range(WORKERS):
        if queue:
            hand(w)
    for w in range(WORKERS):
        if queue and len(pending[w]) <= 2:
            hand(w)
    events = [(pending[w][0], w) for w in range(WORKERS) if pending[w]]
    heapq.heapify(events)
    end = 0.0
    while events:
        now, w = heapq.heappop(events)
        pending[w].popleft()
        end = now
        if queue and len(pending[w]) <= 2:
            hand(w)
        if pending[w]:
            heapq.heappush(events, (now + pending[w][0], w))
    return end, taken


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--move", action="append", default=[])
    ap.add_argument("--scale", action="append", default=[])
    ap.add_argument("--jitter", type=int, default=0)
    args = ap.parse_args(argv)
    files = read_junit(args.junit)
    for spec in args.move:
        src, dst = spec.split(":")
        files.setdefault(dst, []).extend(files.pop(src))
    for spec in args.scale:
        name, factor = spec.split(":")
        files[name] = [t * float(factor) for t in files[name]]

    print(f"{'file (queue order)':48s} {'tests':>5s} {'seconds':>8s}")
    for name in queue_order(files):
        print(f"{name:48s} {len(files[name]):5d} {sum(files[name]):8.1f}")
    end, taken = replay(files)
    print(f"replayed end: {end:.1f} s on {WORKERS} workers")
    for w, names in taken.items():
        print(f"  worker {w}: " + ", ".join(
            f"{n.split('/')[-1][:-3]} {sum(files[n]):.0f}" for n in names))
    if args.jitter:
        ends = sorted(replay(files, random.Random(seed))[0]
                      for seed in range(args.jitter))
        print(f"jitter x{args.jitter}: median {statistics.median(ends):.1f} "
              f"p90 {ends[int(0.9 * len(ends))]:.1f} worst {ends[-1]:.1f}")


if __name__ == "__main__":
    main()
