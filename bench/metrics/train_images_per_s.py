"""train_images_per_s: images of every train step issued in the window,
over the window's seconds (the window ends when the card has finished)."""


def read(r):
    if r.window_s <= 0:
        return None
    return r.done_in_window / r.window_s
