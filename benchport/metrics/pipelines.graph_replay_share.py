"""pipelines.graph_replay_share: the traced window's replays of a captured
CUDA graph (the recorder's counter ``pipelines.graph_replays``) over its
calls into the program (the call ids of its ``api.submit`` spans; a span
nested in another shares its call id).  A call that runs its pipeline
eagerly, is captured, or takes no graph path lowers it."""


def read(r):
    p = r.program
    if p is None:
        return None
    calls = len({s.call for s in p["spans"] if s.name == "api.submit"})
    if not calls:
        return None
    return p["counters"].get("pipelines.graph_replays", 0) / calls
