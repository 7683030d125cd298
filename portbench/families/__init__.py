"""The served programs of the configurations, one module a ``family``.

Each builds its program through the port's own entry points from the
benchmark's seeded weights and inputs, and holds what the program served
to the plain reference under ``reference/``:

- ``weights(cfg, seed, device)``: the seeded parameters, by the
  reference's names;
- ``build(cfg, weights, calib, workdir, device, engine)``: the running
  engine (``engine``: its ``batch_size`` and ``max_delay_ms``);
- ``sites(cfg, batch)`` and ``slice_ideal_s(cfg)``: the counts;
- ``needs_rows``: whether an answer depends on its row in the batch;
- ``compare(cfg, weights, samples, pool, device, batch, bits)``: one
  number a sample against the reference (``bits``: the reference served
  at that precision in the program's place, the control).
"""
