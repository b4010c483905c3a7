"""One driver per kind of traffic (``train``): each builds the system
under test from a configuration and a traffic mix, runs the set-up, the
measured window and the correctness check, and returns a record that the
metric readers under ``metrics/`` reduce."""
