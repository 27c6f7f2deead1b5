"""Traffic generators. A traffic mix (`traffic/<mix>.json`) names its
generator under `generator`; the harness loads
`portbench/generators/<generator>.py` by that name, so a later change adds
a kind of traffic (NumPy input, serving) as a new file here and its mixes
as data files, and edits nothing that is there.

A generator is a module with five functions:

- `setup(cell, seed, device) -> state`: the cell's data from the run's
  seed and every shape its traffic uses warmed (counted as set-up);
- `measure(state, seconds, seed, trace) -> window`: the measured window;
  the window has `attempted`, `failed`, `errors` (strings) and `trace`
  (`tracing.Trace` of its profiled stretch, or None), and whatever the
  cell's per-layer readers read;
- `values(state, window) -> {name: number}`: the end-to-end metrics the
  window measured, by their names before any `.<group>` (the harness
  adds `setup_s`);
- `shape(state)`: what the yardstick counts the work from, or None;
- `check(state, window) -> {name: {"value": v, "limit": l}}`: the
  comparison with the plain reference that decides `correct`, run after
  the window; a number that is not finite, or above its limit, fails.
"""
