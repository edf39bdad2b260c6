"""SplitPlace model serving: execution plans and the SLA-aware engine."""
