"""``pending_ms``: the mean time (ms) the windows of ``window_p90_ms``'s
tail spent from ``submit`` enqueueing the window to the assembler
picking its wave: the wait for a full wave or for the deadline. Read
from the serving program's own stage record (stage ``pending`` of
``repro_torch.serving.metrics.STAGES``, host clock), joined to the
client's rows by ``perfbench/program_record.py``; windows with a NaN
stamp are passed over. Nothing where the program keeps no record, or its
record lost rows of the measured window."""

from perfbench import program_record


def read(run):
    return program_record.tail_stage_ms(run, "pending")
