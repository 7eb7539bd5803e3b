"""images_per_s: images served with status ok inside the window, over the
window's seconds (serving cells)."""


def read(r):
    if r.window_s <= 0:
        return None
    return r.done_in_window / r.window_s
