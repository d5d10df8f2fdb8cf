"""Tests of the benchmark: CPU tests, and the card's under the ``gpu`` marker."""
