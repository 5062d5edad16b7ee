"""The precision policies of the port's folds."""
