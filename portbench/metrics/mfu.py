"""Model FLOPs of the traced ticks' forwards (the cell's model's yardstick)
over their time, in % of the chip's TF32 peak: the whole step's share, which
bounds any kernel's gain."""

from portbench import flops


def read(run):
    t = run.trace
    if not (t.fwd_rows and t.window_s):
        return None
    return t.fwd_rows * run.cell.model.flops_per_row(**t.cell) / (t.window_s * flops.PEAK_TF32_FLOPS) * 100.0
