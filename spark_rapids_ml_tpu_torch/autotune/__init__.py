"""The precision policies of the port's folds, and the tuning cache that
selects the serving variant."""
