"""One module per kind of traffic (a traffic file's "runner"): it builds the
system under test from the configuration and the seed, warms it up, runs
the window, offers a stretch to trace, and judges what the window produced
against the configuration's reference."""
