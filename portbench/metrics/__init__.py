"""One reader per per-layer metric: `read(ctx)` returns the metric's value,
or None where the run has nothing for it to read. `ctx` is built by
`portbench/run.py` in a `--trace 1` run:

  entry, slots, objects   the entry point, slots a step trains, active ones
  window                  `window.Window` of the unprofiled whole units
  obj_iters_per_s, step_s the window's rate and its seconds per train step
  mesh_s                  host seconds of each object's mesh in the window
  host_issue_s            host seconds to issue one step, device idle at its
                          start, over unprofiled steps after the window
  profile                 `trace.read` of the profiled steps (busy_s,
                          launches, span_s, ...), profiled_steps of them;
                          span_s is keyed by the program's own span names
                          (`trace.STEP_SPANS`), and empty where the program
                          has no tracing
  work                    `counts.of`: the encode's least seconds a step,
                          model FLOPs of an object step, the bf16 peak
  peak_window_bytes       the card's peak allocation over the window
"""
