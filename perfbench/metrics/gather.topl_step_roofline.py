"""Kernels, in the gather baseline: the distance + top-l step's share of
its roofline, read as ``topl_step_roofline`` reads it (the step's work
bound is the same whatever merge follows it)."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "topl_step_roofline",
                            ctx.cell.base).read(ctx)
