"""Offline analysis & figure scripts over experiment TSVs
(re-design of ref:plotting/*)."""
