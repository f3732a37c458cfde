"""The PS plane's communication layer: transport, van, rendezvous and the
worker's PS client."""
