"""Drivers, one per kind of traffic: each builds the system under test from
a configuration and a traffic file (`setup`), drives it for the window
(`window`), reports its end-to-end values (`end_to_end`), what the metric
readers need (`work`) and the numbers its check compares (`check`)."""
