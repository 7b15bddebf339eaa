"""Test suite (a package, so `tests.*` imports never resolve to another
installed package named `tests`)."""
