"""The scan's share of its roofline in a ``analyst`` window, in %: the bytes the
traced work needs, counted from the queries (``roofline.py``), over
3.35 TB/s, against the device-busy seconds of the traced slice."""

from olabench import readers


def read(ctx):
    return readers.roofline(ctx, "service")
