"""Plain PyTorch references of the configurations the benchmark runs: one
module a family, named by the `reference` key of a configuration file."""
