"""The yardstick: discovery, inputs, timing, traces, work counts and the
verdict.  Kept apart from the program so that it does not change when the
program does."""
