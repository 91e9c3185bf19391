"""values_per_s: values encrypted or decrypted and returned as host ints in
the window, over the window's seconds (host clock)."""


def read(r):
    if r.window_s <= 0:
        return None
    return r.values / r.window_s
