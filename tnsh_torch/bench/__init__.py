"""The benchmark harness and command line of the parity Twist and Shout."""
