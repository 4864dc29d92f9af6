"""CPU tests of the benchmark; the ones marked ``cuda`` need the card and skip without it."""
