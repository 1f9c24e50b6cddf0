"""Host syncs on the card a traced pass inside the port's spans: the
``pfola.sync`` counter (``torch.cuda.set_sync_debug_mode("warn")``'s warnings)."""

from olabench import spans


def read(ctx):
    return spans.syncs_per_pass(ctx)
