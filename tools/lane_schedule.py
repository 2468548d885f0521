"""Replay the tier-1 lane's pytest-xdist `--dist loadfile` schedule from a
junit report, to see which files set its wall and what moving them buys.

pytest-xdist 3.x hands out whole files, those with the most tests first
(ties in collection order), each to the worker that frees up first.  The
replay uses each file's summed test times from the report (setup, call
and teardown) and ignores worker start-up.

    python tools/lane_schedule.py report.xml [--workers 6] [--last FILE]

--last FILE (default tests/test_isect_replay.py) is the file whose start
is reported.  The schedule is also replayed with every
tests/test_torch_port_*.py file handed out after FILE (as if split into
files of one test), and with no port tests at all.
"""

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_times(path):
    """{file: [number of tests, seconds]} in report order."""
    files = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        f = tc.get("classname").replace(".", "/") + ".py"
        row = files.setdefault(f, [0, 0.0])
        row[0] += 1
        row[1] += float(tc.get("time"))
    return files


def replay(order, workers):
    """Greedy list schedule -> (wall seconds, {file: start seconds})."""
    free = [(0.0, i) for i in range(workers)]
    heapq.heapify(free)
    start = {}
    for f, (_, seconds) in order:
        t, i = heapq.heappop(free)
        start[f] = t
        heapq.heappush(free, (t + seconds, i))
    return max(t for t, _ in free), start


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("report")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--last", default="tests/test_isect_replay.py")
    args = ap.parse_args()
    files = file_times(args.report)
    order = sorted(sorted(files.items()), key=lambda kv: -kv[1][0])
    wall, start = replay(order, args.workers)
    print(f"as reported: wall {wall:.1f} s; {args.last} starts at "
          f"{start[args.last]:.1f} s and takes {files[args.last][1]:.1f} s")
    for f, (n, seconds) in order:
        print(f"{n:4d} {seconds:8.1f} s  start {start[f]:7.1f}  {f}")
    others = [kv for kv in order if "test_torch_port_" not in kv[0]]
    port = [kv for kv in order if "test_torch_port_" in kv[0]]
    k = [f for f, _ in others].index(args.last) + 1
    for what, o in (("port files after it", others[:k] + port + others[k:]),
                    ("no port files", others)):
        wall, start = replay(o, args.workers)
        print(f"{what}: wall {wall:.1f} s; {args.last} starts at "
              f"{start[args.last]:.1f} s")


if __name__ == "__main__":
    main()
