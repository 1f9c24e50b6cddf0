"""Traffic of kind ``join_passes``: exact shared passes of a bundle that joins
lineitem with replicated dimension tables, run as the ``passes`` driver runs
them (``olabench/passes.py``: the same loop, draws, timing, sample and
check), with four differences.

- A pass's results are let go when the next pass starts, unless the check
  keeps them (the ``passes`` driver holds them one pass longer), and a kept
  pass keeps only what the check reads: each member's final, estimates,
  bounds, scanned and matched.  At SF 100 a pass's results are 6.8 GB (Q10's
  [R, G] states and estimates), and the card holds the table, the next
  pass's round states and two kept passes, not four whole ones.
- Set-up runs its warm passes, and the last of them while holding as many
  kept results as the check keeps (the first warm pass's, and copies of
  it), so that the caching allocator maps the memory they take before the
  window: mapped inside it, 3.9 GB a kept pass cost 20-300 ms.
- A traced run also counts the device seconds of every kernel of the
  port's group step (``pfola::group_*``) and the bytes the group step of the
  traced passes needs (:func:`group_step_bytes`), which
  ``group_step_roofline.join`` reads.
- Where a join's probe tables pass the reference's budget, the bundle
  leaves K1 for the legacy path (K3, ``scan.bundle_kernel_rounds_states``).
  A program without ``ops.group_agg_bundle`` runs that path as one table
  of every member's groups, whose round outputs the card cannot hold at
  SF 100, so importing this module raises there, before set-up.
"""
from __future__ import annotations

from olabench import passes
from olabench.passes import as_outputs, compare, reference_answers  # noqa: F401


def _require_per_member_k3() -> None:
    from repro_torch.kernels import ops

    if not hasattr(ops, "group_agg_bundle"):
        raise RuntimeError(
            "this program runs a K3 bundle as one table of every member's groups "
            "(it has no ops.group_agg_bundle): the join_passes traffic needs "
            "each member launched at its own shape")


_require_per_member_k3()

GROUP_STEP_KERNELS = "pfola::group_"  # group_partials_kernel, group_fold_kernel


def group_step_bytes(qs, slots: int, partitions: int, rounds: int) -> int:
    """The bytes the K3 group step of one pass of ``qs`` needs: each
    member's vals, w and gids read once (``4A + 8`` bytes a row slot of the
    ``slots`` the layout holds, the masked ones too: the launch reads them),
    and its sums, sumsqs and matched written once a round-slice, a
    partition each.  A scalar member is one group."""
    out = 0
    for q in qs:
        A, G = len(q.exprs), int(q.groups)
        out += slots * (4 * A + 8) + 4 * rounds * partitions * G * (2 * A + 1)
    return out


def group_step_seconds(events) -> float:
    """Device seconds of the group step's kernels among profiler events."""
    from torch.autograd import DeviceType

    return sum(e.time_range.end - e.time_range.start for e in events
               if e.device_type == DeviceType.CUDA and GROUP_STEP_KERNELS in e.key) / 1e6


def _kept(res):
    """A member's result with only what the check reads."""
    return res._replace(snapshots=res.snapshots._replace(sum=None, sumsq=None),
                        estimates=res.estimates._replace(info=None))


def _copy(results):
    from repro_torch.uda import tree_map

    return tree_map(lambda x: x.clone(), results)


class Driver(passes.Driver):
    def __init__(self, cell, seed: int, device, shards, dims=None):
        super().__init__(cell, seed, device, shards, dims)
        self.slots = 0 if shards is None else int(shards["_mask"].numel())

    def one_pass(self, qs):
        # another pass starts, so the last one was not the window's last
        for i in [i for i in self.done if i not in self.keep]:
            del self.done[i]
        return [_kept(r) for r in super().one_pass(qs)]

    def run(self, seconds: float, tracer=None) -> dict:
        held = []
        for _ in range(int(self.mix["warmup_passes"])):
            out = self.one_pass(self.draw())
            if not held:
                held = [out] + [_copy(out) for _ in range(len(self.keep) - 1)]
            del out
        del held
        self.mix = dict(self.mix, warmup_passes=0)  # warmed above
        res = super().run(seconds, tracer)
        ctx = res["ctx"]
        if ctx.get("traced_passes"):
            qs = self.done[max(self.done)][0]
            ctx["traced_group_step_s"] = group_step_seconds(tracer.prof.events())
            ctx["traced_group_step_bytes"] = ctx["traced_passes"] * group_step_bytes(
                qs, self.slots, self.P, self.rounds)
        return res
