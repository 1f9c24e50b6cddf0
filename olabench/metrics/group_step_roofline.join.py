"""The K3 group step's share of its roofline in a ``join_passes`` window, in
%: the bytes its launches in the traced passes need (each member's vals, w
and gids read once, its three outputs written once a round-slice:
``drivers/join_passes.group_step_bytes``) over 3.35 TB/s, against the
traced device seconds of every ``pfola::group_*`` kernel."""

from olabench.roofline import HBM_BYTES_PER_S


def read(ctx):
    s, b = ctx.get("traced_group_step_s"), ctx.get("traced_group_step_bytes")
    if ctx.get("kind") != "passes" or not s or not b:
        return None
    return 100.0 * b / HBM_BYTES_PER_S / s
