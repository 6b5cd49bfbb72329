"""The benchmark's yardstick: the H100's published peaks, the least time
an MSDA call could take, and the detector's operation counts."""
