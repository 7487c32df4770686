"""Request identity crossing the backend seam (reqtrace.py); the flight
recorder, perf attribution and span recorder come with ROADMAP queue 1,
item 7."""
