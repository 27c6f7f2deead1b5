"""The Corex estimator."""
