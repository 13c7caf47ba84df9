"""The serving layer's pieces that the durable replica uses: so far only
``metrics`` (the histograms behind the WAL and op-log telemetry)."""
