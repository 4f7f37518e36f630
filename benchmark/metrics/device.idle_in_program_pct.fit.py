"""device.idle_in_program_pct.fit: the share of the card's idle time in
the traced stretch of steps that falls under one of the program's `pbr.*`
spans; the reader of `device.idle_in_program_pct.frame`, which moves
`frame_ms` where this one moves `step_s`."""

from harness.bench import metric_reader

read = metric_reader("device.idle_in_program_pct.frame").read
