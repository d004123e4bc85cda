"""Several GPUs: the ('data', 'model') mesh over a process group."""
