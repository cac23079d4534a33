"""Job health: the step-time heartbeat monitor."""
