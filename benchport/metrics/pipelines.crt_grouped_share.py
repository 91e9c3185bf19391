"""pipelines.crt_grouped_share: the recorded window's CRT decrypts that ran
the grouped layout (the recorder's counter ``pipelines.crt_grouped``: one
residue system of p^2 / q^2 a group of K5) over its calls into the program
(the call ids of its ``api.submit`` spans).  1.0 where every call runs the
grouped layout.  A window that never raised the counter, as a program
without it never does, reads nothing."""


def read(r):
    p = r.program
    if p is None or "pipelines.crt_grouped" not in p["counters"]:
        return None
    calls = len({s.call for s in p["spans"] if s.name == "api.submit"})
    if not calls:
        return None
    return p["counters"]["pipelines.crt_grouped"] / calls
