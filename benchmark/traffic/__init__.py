"""Traffic kinds: one module a kind, each generating and serving its mixes."""
