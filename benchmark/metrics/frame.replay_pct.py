"""frame.replay_pct: the share of the traced stretch's frames that replayed
the dense frame's CUDA graph (`integrator/frame_graph.py` of the port), in
percent: 100 x the `pbr.frame.replay` spans that start inside the stretch
over its frames: 0 where the stretch's frames replayed none (a tree
without the graph, or one that did not engage it); None where there is no
stretch or it holds no frame."""

SPAN = "pbr.frame.replay"


def read(readings):
    s = readings.stretch
    if s is None or not s.units:
        return None
    n = sum(1 for name, a, _ in s.host_ops
            if name == SPAN and s.t0 <= a < s.t1)
    return 100.0 * n / s.units
