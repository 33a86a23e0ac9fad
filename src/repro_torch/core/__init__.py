"""Chunked-pipeline core: plan, staging, attention, transport, remote
access, stage programs and the tick driver."""
