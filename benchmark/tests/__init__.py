"""Tests of the benchmark (CPU at toy sizes; ``gpu`` ones on the card)."""
