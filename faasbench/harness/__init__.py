"""The benchmark's yardstick: everything a cell's run shares."""
