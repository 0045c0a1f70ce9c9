"""The benchmark's yardstick: cell resolution, the measured window, the
reduction of profiler traces, roofline arithmetic and the comparison that
decides ``correct``."""
