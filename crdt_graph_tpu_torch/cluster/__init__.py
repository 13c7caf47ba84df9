"""The fleet (gateway, leases, anti-entropy) is not ported yet (ROADMAP
Queue 1 item 6); ``gateway`` holds only the error class the HTTP
handlers name."""
