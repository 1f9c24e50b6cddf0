"""The scan's share of its roofline in a ``join_passes`` window, in %: the
bytes the traced work needs, counted from the queries (``roofline.py``: the
columns once, each probed dimension column once a pass, the states), over
3.35 TB/s, against the device-busy seconds of the traced slice.  The same
quantity as ``scan_roofline.report``, read by its reader."""

from olabench import bench

read = bench.metric_reader("scan_roofline.report")
