"""One driver per kind of traffic: set-up, the measured window, the check."""
