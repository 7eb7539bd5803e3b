"""The benchmark's yardstick: cells resolved by name, inputs from the seed,
the drivers, the device-trace reduction, the work counts and the check."""
