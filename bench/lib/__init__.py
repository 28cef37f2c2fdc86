"""The harness: traffic, weights, the window, traces, counts and the check."""
