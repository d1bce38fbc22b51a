"""Controllers: PID/APF drives, the wanderer, timed primitives, RANSAC
alignment."""
