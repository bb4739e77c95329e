"""Plain PyTorch references of the benchmark's configurations, one module
a configuration, named as the configuration is."""
