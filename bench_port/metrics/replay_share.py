"""replay_share: the share of the traced window's steps that ran as
replays of the captured step, the mean of the program's step counter
`graph_replays` (1 for a replayed step, 0 for an eager one), in %. A
program without the counter gives None."""
from bench_port.spans import window


def read(rec: dict, cell: dict):
    w = window(rec)
    if w is None:
        return None
    counted = [c["graph_replays"] for c in w.counters.values()
               if "graph_replays" in c]
    if not counted:
        return None
    return 100.0 * sum(counted) / w.steps
