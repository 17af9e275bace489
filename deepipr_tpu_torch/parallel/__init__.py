"""Several processes: process-group set-up, the (batch, model) mesh, data
and tensor parallelism."""
