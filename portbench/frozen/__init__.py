"""Frozen copies of the program's traffic generators, prior arithmetic
and roofline arithmetic: the yardstick does not move when the program
does. tests/test_portbench_frozen.py holds them against the program."""
