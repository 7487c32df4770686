"""Engine observability, copies of vgate_tpu/observability/:

* :mod:`~vgate_tpu_torch.observability.flight` — the flight recorder: a
  ring of engine ticks plus bounded per-request records, dumped on every
  crash and served live via ``/debug``;
* :mod:`~vgate_tpu_torch.observability.reqtrace` — per-request phase
  spans parented on the HTTP request span;
* :mod:`~vgate_tpu_torch.observability.memtrace` — an in-memory span
  recorder on the OTel API alone (``/debug/spans`` with
  ``VGT_MEMTRACE``);
* :mod:`~vgate_tpu_torch.observability.perf` — per-tick phase
  attribution, the compile ledger and the MFU / HBM-roofline gauges
  (``/debug/perf``);
* :mod:`~vgate_tpu_torch.observability.roofline` — the device peak
  table, with the H100's row.
"""
