"""Train and eval steps, the SGD schedule, the train state and the
device-resident epoch."""
