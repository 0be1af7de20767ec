"""One adapter per entry point of the program that a configuration
drives, found by the configuration's ``entry`` name."""
