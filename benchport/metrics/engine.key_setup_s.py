"""engine.key_setup_s: seconds of the engines' first use in set-up: their
constants (RNS contexts, the fixed-base table, CRT constants) and a first
batch on the default stream, synchronised."""


def read(r):
    s = r.spans.get("key_setup")
    return s[0] if s else None
