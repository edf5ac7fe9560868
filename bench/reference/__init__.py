"""The plain reference: SSB's queries evaluated on the logical state at an
epoch, rebuilt from the generated tables and the writer's log.  It imports
torch and numpy only, nothing of the system under test."""
